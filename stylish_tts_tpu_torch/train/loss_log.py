"""Loss accounting: the weighted total and the self-normalised backwards
loss.

Every metric except ``generator`` and ``align_loss`` is divided by its own
detached magnitude before weighting (a gradient-balancing device), while
the reported total is the plain weighted sum.
"""

from __future__ import annotations

from typing import Mapping

import torch

RAW_KEYS = ("generator", "align_loss")


def backwards_loss(metrics: Mapping[str, torch.Tensor],
                   weights: Mapping[str, float]) -> torch.Tensor:
    total = 0.0
    for key, value in metrics.items():
        loss = value if key in RAW_KEYS else value / (value.detach() + 1e-9)
        total = total + loss * weights.get(key, 1.0)
    return total


def weighted_total(metrics: Mapping[str, torch.Tensor],
                   weights: Mapping[str, float]) -> torch.Tensor:
    total = 0.0
    for key, value in metrics.items():
        total = total + value * weights.get(key, 1.0)
    return total

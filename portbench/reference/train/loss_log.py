"""Loss accounting: the weighted total and the self-normalised backwards
loss.

Every metric except ``generator`` and ``align_loss`` is divided by its own
detached magnitude before weighting (a gradient-balancing device), while
the reported total is the plain weighted sum.  ``combine_metrics`` and
``format_metrics`` average and print the logged values on the host.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def combine_metrics(metric_list) -> Dict[str, float]:
    """Host-side mean of each metric over the logged steps."""
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for metrics in metric_list:
        for key, value in metrics.items():
            totals[key] = totals.get(key, 0.0) + float(value)
            counts[key] = counts.get(key, 0) + 1
    return {k: totals[k] / counts[k] for k in totals}


def format_metrics(metrics: Mapping[str, float], total: float) -> str:
    parts = [f"{k}: {float(v):.3f}" for k, v in metrics.items()]
    return f"loss: {total:.3f}, " + ", ".join(parts)

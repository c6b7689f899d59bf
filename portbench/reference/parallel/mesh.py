"""The reductions of one process: the plain torch ones the models call."""

from __future__ import annotations

import torch


def world_size() -> int:
    return 1


def sum(x: torch.Tensor) -> torch.Tensor:  # noqa: A001  (torch.sum's name)
    return torch.sum(x)


def mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x)


def gather(x: torch.Tensor) -> torch.Tensor:
    return x


def moments(flat: torch.Tensor):
    """(mean, biased variance) over axis 0 of [N, C]: flax's E[x²] −
    E[x]², clamped at 0."""
    mean_, mean2 = flat.mean(dim=0), (flat * flat).mean(dim=0)
    return mean_, torch.clamp(mean2 - mean_ * mean_, min=0)

"""Parameter counts and forward timing (reference train/test.py:46-118,
train/cli_util.py:6-21): a table of each module's parameters and the wall
time of a forward on random inputs."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
from torch import nn


def count_params(module: nn.Module) -> int:
    """The module's parameters (its buffers, such as spectral-norm vectors
    or batch-norm statistics, are not counted, as the JAX package counts
    its ``params`` collection only)."""
    return sum(p.numel() for p in module.parameters())


def param_table(models: Dict[str, nn.Module]) -> str:
    """One row a module, ``module  1,234`` with the name padded, then the
    total: the JAX package's ``param_table`` layout."""
    rows = [(key, count_params(module)) for key, module in models.items()]
    rows.append(("TOTAL", sum(n for _, n in rows)))
    width = max(len(k) for k, _ in rows)
    lines = [f"{'module':<{width}}  params"]
    for key, n in rows:
        lines.append(f"{key:<{width}}  {n:,}")
    return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_forward(fn: Callable, args, iters: int = 10,
                 device: torch.device = torch.device("cpu")) -> float:
    """Mean wall seconds of ``fn(*args)`` over ``iters`` calls, after one
    warm-up call (cuDNN's algorithm choice, the allocator's growth); on the
    card the span ends in ``torch.cuda.synchronize()``."""
    device = torch.device(device)
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters

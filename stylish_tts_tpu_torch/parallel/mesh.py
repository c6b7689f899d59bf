"""The reductions that make a step over R ranks compute what one process
computes on the global batch (the JAX package's GSPMD semantics: one
global batch sharded over the data axis, every reduction global).

Each rank holds a contiguous block of the global batch, every block of
the same shape.  Every loss and metric is the global batch's: a mean is
the mean of the ranks' means (``mean``; equal counts), a ratio of sums
all-reduces both sums (``sum``), and a quantile sees the all-gathered
values (``gather``).
Train-mode batch norms take the global batch's moments the same way.
These collectives are the differentiable ones of
``torch.distributed.nn.functional``: their backward all-reduces the
gradient, so every rank's backward of the (identical) global loss gives
R times that loss's gradient summed over the ranks' parameters.
``sync_gradients`` therefore sums each trained module's gradients over
the ranks in one flat bucket and divides by R.

Without a process group every function is the plain torch reduction,
bit for bit; with one (a world of one included) the collectives run, and
``COLLECTIVES`` counts them by kind.  A world of one computes the plain
reductions' values bit for bit too: the ranks' means are reduced, not
their sums divided by a count.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List

import torch
import torch.distributed as dist
from torch import nn


# the collectives run since the process started, by kind
COLLECTIVES: Counter = Counter()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _active() -> bool:
    return dist.is_initialized()


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.nn.functional import all_reduce

    COLLECTIVES["all_reduce"] += 1
    return all_reduce(x, op=dist.ReduceOp.SUM)


def sum(x: torch.Tensor) -> torch.Tensor:  # noqa: A001  (torch.sum's name)
    """The global batch's ``torch.sum(x)``."""
    if not _active():
        return torch.sum(x)
    return _all_reduce(torch.sum(x))


def mean(x: torch.Tensor) -> torch.Tensor:
    """The global batch's ``torch.mean(x)``: every rank's block has the
    same shape, so it is the mean of the ranks' means."""
    if not _active():
        return torch.mean(x)
    return _all_reduce(torch.mean(x)) / world_size()


def gather(x: torch.Tensor) -> torch.Tensor:
    """The global batch's ``x``: the ranks' blocks concatenated along the
    batch axis, in rank order."""
    if not _active():
        return x
    from torch.distributed.nn.functional import all_gather

    COLLECTIVES["all_gather"] += 1
    return torch.cat(all_gather(x.contiguous()), dim=0)


def moments(flat: torch.Tensor):
    """(mean, biased variance) over axis 0 of [N, C], of the global
    batch: flax's E[x²] − E[x]², clamped at 0."""
    mean_, mean2 = flat.mean(dim=0), (flat * flat).mean(dim=0)
    if _active():
        means = _all_reduce(torch.stack([mean_, mean2])) / world_size()
        mean_, mean2 = means[0], means[1]
    return mean_, torch.clamp(mean2 - mean_ * mean_, min=0)


@torch.no_grad()
def host_sum(x: torch.Tensor) -> torch.Tensor:
    """All-reduced sum of ``x`` (not differentiable), a new tensor."""
    x = x.clone()
    if _active():
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any (all-reduce MAX):
    a decision that every rank must take together."""
    if not _active():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def max_int(value: int, device) -> int:
    """The largest ``value`` over the ranks."""
    if not _active():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


@torch.no_grad()
def sync_gradients(modules: Iterable[nn.Module]) -> int:
    """Sum each module's parameter gradients over the ranks and divide by
    R, in one flat bucket per module; returns the number of all-reduces.
    A parameter without a gradient counts as zeros, and keeps None."""
    if not _active():
        return 0
    r = world_size()
    launched = 0
    for module in modules:
        params = [p for p in module.parameters() if p.requires_grad]
        if not params:
            continue
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in params])
        COLLECTIVES["gradient_all_reduce"] += 1
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        launched += 1
        flat /= r
        offset = 0
        for p in params:
            n = p.numel()
            if p.grad is not None:
                p.grad.copy_(flat[offset:offset + n].view_as(p))
            offset += n
    return launched


@torch.no_grad()
def broadcast_modules(modules: Iterable[nn.Module]) -> None:
    """Every parameter and buffer takes rank 0's value."""
    if not _active():
        return
    for module in modules:
        for t in list(module.parameters()) + list(module.buffers()):
            COLLECTIVES["broadcast"] += 1
            dist.broadcast(t.data, src=0)


@torch.no_grad()
def check_equal(modules: Iterable[nn.Module]) -> List[str]:
    """Names of the parameters and buffers that differ between the ranks
    (max minus min over the ranks of a per-tensor checksum); empty when
    all agree."""
    if not _active():
        return []
    names, sums = [], []
    for i, module in enumerate(modules):
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            names.append(f"{i}.{name}")
            v = t.detach().double().reshape(-1)
            sums.append(torch.stack([v.sum(), (v * v).sum(),
                                     (v * torch.arange(
                                         v.numel(), device=v.device,
                                         dtype=v.dtype)).sum()]))
    if not sums:
        return []
    block = torch.stack(sums)
    hi, lo = block.clone(), block.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    bad = (hi != lo).any(dim=1).nonzero().reshape(-1).tolist()
    return [names[i] for i in bad]

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

The OOM guard's common decision (``oom_on_any_rank``) goes through the
process group's store, never through a collective: a collective could
pair with one that a rank still waits in.

Without a process group every function is the plain torch reduction,
bit for bit; with one (a world of one included) the collectives run, and
``COLLECTIVES`` counts them by kind.  A world of one computes the plain
reductions' values bit for bit too: the ranks' means are reduced, not
their sums divided by a count.
"""

from __future__ import annotations

import json
import time
from collections import Counter
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn


# the collectives run since the process started, by kind
COLLECTIVES: Counter = Counter()
# how long a rank that ran out of memory waits for the others to reach the
# guard before it stops the run: a rank that is still in a collective of
# its step never reaches it
GUARD_WAIT_S = 60.0
# how long a rank whose collective failed waits for the failing rank's
# verdict, and a failing rank that holds the store for the others to read
# it
RECORD_WAIT_S = 10.0
_GUARD_PREFIX = "stylish_oom_guard"


def collective_count() -> int:
    """The collectives this process has issued through this module."""
    return COLLECTIVES.total()


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


class RankFailure(RuntimeError):
    """A rank ran out of memory where the ranks cannot restore together:
    raised on every rank, naming the one that failed."""


class _Decision:
    """The keys of the current guard decision in the process group's
    store.  Every rank takes the decisions in the same order and counts
    its own in the store, so a new group (a new store) starts at 0."""

    def __init__(self):
        self.store = dist.distributed_c10d._get_default_store()
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.count_key = f"{_GUARD_PREFIX}/count/{self.rank}"
        self.index = int(self.store.add(self.count_key, 0))

    def key(self, name, index: Optional[int] = None) -> str:
        return f"{_GUARD_PREFIX}/{self.index if index is None else index}" \
               f"/{name}"

    def done(self) -> None:
        self.store.add(self.count_key, 1)

    def stop(self, message: str) -> RankFailure:
        """Record ``message`` as the verdict and abort the process group.
        A card's rank waiting for the decision reads the verdict and aborts
        its own group, which releases its collectives.  Over gloo a rank
        waiting in a collective is released only when this process's
        connections close, at its exit, and then reads the verdict.  Rank
        0 holds the store, so it waits up to RECORD_WAIT_S for the others
        to read it first."""
        self.store.set(self.key("verdict"), message)
        _abort()
        deadline = time.monotonic() + RECORD_WAIT_S
        while (self.rank == 0 and time.monotonic() < deadline
               and int(self.store.add(self.key("read"), 0)) < self.world - 1):
            time.sleep(0.01)
        return RankFailure(message)


def _abort() -> None:
    dist.distributed_c10d._abort_process_group()


def rank_failure() -> Optional[RankFailure]:
    """After a collective raised: the failure another rank recorded for
    the current guard decision (the process group is then aborted here
    too), or None where none was recorded within ``RECORD_WAIT_S`` or no
    other rank exists.  When the store is gone, rank 0, which held it, has
    stopped."""
    if world_size() == 1:
        return None
    try:
        decision = _Decision()
        verdict = decision.key("verdict")
        deadline = time.monotonic() + RECORD_WAIT_S
        while not decision.store.check([verdict]):
            if time.monotonic() > deadline:
                return None
            time.sleep(0.01)
        message = decision.store.get(verdict).decode()
        decision.store.add(decision.key("read"), 1)
    except dist.DistError as exc:
        message = (f"rank 0 stopped the run: the process group's store it "
                   f"held is gone ({exc})")
    _abort()
    return RankFailure(message)


def _where(collectives: int) -> str:
    return ("before its step's first collective" if not collectives
            else f"after {collectives} of the step's collectives")


def oom_on_any_rank(message: Optional[str], collectives: int) -> bool:
    """The OOM guard's decision, taken on every rank after its step:
    True on every rank when one ran out of memory (``message``) and all
    can restore together, False when none did.

    The ranks decide through the process group's store, never through a
    collective, which could pair with a collective that a rank still
    waits in.  Each rank posts whether it failed and how many collectives
    its step issued (``collectives``).  They restore together when every
    rank posts and all issued the same collectives, as where every rank
    ran out of memory at the same point (same shapes, same collectives) or
    before its first collective, or where the world is one.  Otherwise
    the step's collectives are mis-paired and a rank may wait in one that
    no other rank will join, so a ``RankFailure`` naming the failing rank
    is raised on every rank and the group is aborted:

    * a rank that failed waits up to ``GUARD_WAIT_S`` for the others to
      post, and stops the run where one does not (it waits in a collective
      of its step);
    * where every rank posted and the counts differ, every rank stops (a
      card's collectives run asynchronously, so a rank may post while its
      card waits in one);
    * a rank whose step raised in a collective reads the failing rank's
      verdict (``rank_failure``)."""
    if not _active():
        return message is not None
    decision = _Decision()
    store, rank = decision.store, decision.rank
    failed = message is not None
    store.set(decision.key(str(rank)),
              json.dumps([failed, collectives, message]))
    if decision.index >= 2:
        # every rank has posted to the last decision, so each has read the
        # one before it: this rank's post there can go
        store.delete_key(decision.key(str(rank), decision.index - 2))
    keys = [decision.key(str(r)) for r in range(decision.world)]
    start = time.monotonic()
    while not store.check(keys):
        if store.check([decision.key("verdict")]):
            raise rank_failure()
        waited = time.monotonic() - start
        if failed and waited > GUARD_WAIT_S:
            raise decision.stop(
                f"rank {rank} ran out of memory {_where(collectives)} "
                f"({message}), and not every rank reached the guard within "
                f"{GUARD_WAIT_S:.0f} s: the run stops on every rank")
        if waited > store.timeout.total_seconds():
            raise RuntimeError(f"rank {rank} waited {waited:.0f} s for the "
                               f"other ranks at the OOM guard")
        time.sleep(0.005)
    posts = [json.loads(store.get(k)) for k in keys]
    decision.done()
    failing = [r for r, (f, _, _) in enumerate(posts) if f]
    counts = {n for _, n, _ in posts}
    if failing and len(counts) > 1:
        first = failing[0]
        _abort()
        raise RankFailure(
            f"rank {first} ran out of memory {_where(posts[first][1])} "
            f"({posts[first][2]}), and the ranks issued "
            f"{[n for _, n, _ in posts]} collectives: they cannot restore "
            f"together, so the run stops on every rank")
    return bool(failing)


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

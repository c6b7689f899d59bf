"""The traced segment of a ``--trace 1`` run: torch.profiler over a few
steps or batches, its Chrome trace written to ``TMPDIR`` and read back, and
the calls into the program's kernels recorded from outside, with their
shapes, so that per-layer readers can count their work.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; annotations and ``record_function`` ranges on the
device side are left out.  The window is the host's span of the segment,
marked by a ``record_function`` range that ends after a synchronize.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


@dataclass
class Segment:
    """What one traced segment saw.  Times in seconds."""

    units: int  # steps or batches traced
    window_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, duration)
    host_ops: List[Tuple[str, float, float]]
    calls: Dict[str, List[tuple]]  # recorded calls into the program
    flops: List[Dict[str, float]] = field(default_factory=list)  # a unit

    def kernels(self, *names: str) -> List[Tuple[str, float, float]]:
        """The device operations whose name holds one of ``names``."""
        return [op for op in self.device_ops if any(n in op[0]
                                                    for n in names)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((s, s + d) for _, s, d in self.device_ops)
        merged: List[List[float]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device_ops:
            by_name[name[:120]] += dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = [(hi, lo2) for (_, hi), (lo2, _) in zip(busy, busy[1:])]
        if busy:
            gaps = [(0.0, busy[0][0])] + gaps + [(busy[-1][1],
                                                  self.window_s)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[self._host_during(lo, hi), hi - lo]
                              for lo, hi in gaps]}

    def _host_during(self, lo: float, hi: float) -> str:
        """The innermost (shortest) host operation that covers at least
        half of [lo, hi]; failing one, the one that overlaps it most."""
        covering, best, most = None, "nothing traced", 0.0
        for name, s, d in self.host_ops:
            overlap = min(hi, s + d) - max(lo, s)
            if overlap >= 0.5 * (hi - lo) and (covering is None
                                                or d < covering[1]):
                covering = (name, d)
            if overlap > most:
                best, most = name, overlap
        return (covering[0] if covering else best)[:120]


class CallRecorder:
    """Wraps callables of the program for the segment's length and records
    each call's arguments as ``describe`` reduces them (shapes, not
    tensors)."""

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, label: str,
             describe: Callable[..., tuple]) -> None:
        original = getattr(owner, attr)
        record = self.calls[label]

        def wrapped(*args, **kwargs):
            record.append(describe(*args, **kwargs))
            return original(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, original))

    def restore(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


@contextmanager
def profiled():
    """torch.profiler over the block, inside the window's range; yields a
    holder whose ``events`` are filled on exit."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def segment(events: list, units: int, calls: Dict[str, List[tuple]]
            ) -> Segment:
    """The window's device and host operations, in seconds from its start."""
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window range")
    t0, length = float(window[0]["ts"]), float(window[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or e.get("name") == WINDOW:
            continue
        start, dur = float(e["ts"]) - t0, float(e["dur"])
        lo, hi = max(start, 0.0), min(start + dur, length)
        if hi <= lo:
            continue
        item = (e["name"], lo * 1e-6, (hi - lo) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            device.append(item)
        elif e.get("cat") in HOST_CATS:
            host.append(item)
    return Segment(units=units, window_s=length * 1e-6, device_ops=device,
                   host_ops=host, calls=dict(calls))

"""What the span readers in ``metrics/`` share.  The program names its
phases with ``span`` (``stylish_tts_tpu_torch/utils/profiling.py``): under
the profiler each is a ``user_annotation`` range among the segment's host
operations, on the device trace's clock.  The card's idle time (the window
less the union of device operations) is split here by the spans the host
was in.  A function returns None where the segment holds none of the spans
it reads, as a program without them leaves it: the metric is then left out
of the result's line.

``owners`` reads the raw trace besides: which span and which host
operation launched each device operation, through the trace's correlation
ids (``span_report.py``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import DEVICE_CATS, Segment

Interval = Tuple[float, float]

# the train step's phases whose idle time the metrics report; each is the
# union of its spans, and the three are disjoint inside ``train.step``
STEP = "train.step"
PHASES = {"forward": ("train.losses", "train.gan"),
          "backward": ("train.backward",),
          "optimizer": ("train.zero_grad", "train.optimizer")}
UPLOAD = "synth.upload"
PROGRAM = ("train.", "synth.")  # the prefixes of the program's spans


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The parts of the merged intervals ``a`` outside the merged ``b``,
    in one pass over both."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append((lo, hi))
    return out


def intersect(a: Sequence[Interval], b: Sequence[Interval]
              ) -> List[Interval]:
    return subtract(a, subtract(a, b))


def length(intervals: Iterable[Interval]) -> float:
    return sum(hi - lo for lo, hi in intervals)


def spans(seg: Segment, names: Iterable[str]) -> List[Interval]:
    """The union of the host intervals of the spans named ``names``."""
    names = set(names)
    return union((s, s + d) for name, s, d in seg.host_ops if name in names)


def idle(seg: Segment) -> List[Interval]:
    """The window less the union of the device operations."""
    return subtract([(0.0, seg.window_s)], seg.busy_intervals())


def idle_s(seg: Segment, inside: Optional[Iterable[str]],
           outside: Iterable[str] = ()) -> Optional[float]:
    """Seconds the card was idle while the host was inside a span named in
    ``inside`` (None: anywhere in the window) and in none named in
    ``outside``; None where no span of ``inside`` was traced."""
    where = [(0.0, seg.window_s)] if inside is None else spans(seg, inside)
    if not where:
        return None
    return length(subtract(intersect(idle(seg), where),
                           spans(seg, outside)))


def idle_pct(seg: Segment, inside: Optional[Iterable[str]],
             outside: Iterable[str] = ()) -> Optional[float]:
    """``idle_s`` as a share of the traced window, in %; None also where
    the segment holds no device operation (as ``readers.idle_pct``)."""
    seconds = idle_s(seg, inside, outside)
    if seconds is None or seg.window_s <= 0 or not seg.device_ops:
        return None
    return 100.0 * seconds / seg.window_s


def phase_idle_pct(seg: Segment, phase: str) -> Optional[float]:
    return idle_pct(seg, PHASES[phase])


def remainders_pct(seg: Segment) -> Optional[Dict[str, float]]:
    """The idle time the three phases leave, as shares of the window: in
    ``train.step`` outside them (``_set_trainable``, the dropout set-up,
    the gradient sync, the totals), and outside ``train.step`` (the
    benchmark's feed and loop)."""
    phases = [n for names in PHASES.values() for n in names]
    in_step = idle_pct(seg, [STEP], phases)
    if in_step is None:
        return None
    return {"in_step": in_step, "outside_step": idle_pct(seg, None, [STEP])}


def durations(seg: Segment, name: str) -> List[float]:
    return [d for n, _, d in seg.host_ops if n == name]


def per_unit_ms(seg: Segment, name: str) -> Optional[float]:
    """Host milliseconds inside spans ``name``, per traced unit."""
    found = durations(seg, name)
    if not found or seg.units <= 0:
        return None
    return 1e3 * sum(found) / seg.units


class _Nest:
    """The host operations of one thread, nested as they ran: the ops
    around a time, from the innermost out."""

    def __init__(self, ops: List[Tuple[float, float, str, object]]):
        self.ops = sorted(ops, key=lambda o: (o[0], -o[1]))
        self.starts = [o[0] for o in self.ops]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (lo, hi, _, _) in enumerate(self.ops):
            while stack and self.ops[stack[-1]][1] < hi:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, ts: float) -> List[Tuple[float, float, str, object]]:
        i = bisect.bisect_right(self.starts, ts) - 1
        out = []
        while i >= 0:
            if self.ops[i][0] <= ts <= self.ops[i][1]:
                out.append(self.ops[i])
            i = self.parent[i]
        return out


BACKWARD = "autograd::engine::evaluate_function"


def owners(events: list, kernels: Iterable[str]
           ) -> Dict[str, Dict[str, float]]:
    """Device seconds of each device operation whose name holds one of
    ``kernels``, by who launched it: ``"<span> | <outermost host op> |
    <innermost host op>"``.  The launch is the runtime call with the
    operation's correlation id; the ops are those around it on its thread,
    the span the innermost program span around it on any thread (the
    backward's ops run on autograd's thread, inside ``train.backward``).
    A backward node's span reads ``train.backward < <span>``: the span of
    the first op with the node's sequence number on a thread that ran no
    backward node (the forward that made the node)."""
    kernels = tuple(kernels)
    launches, ops, program = {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        lo = float(e["ts"])
        hi = lo + float(e["dur"])
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (lo, e.get("tid"))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((lo, hi, e["name"],
                                      args.get("Sequence number")))
        elif cat == "user_annotation" and e["name"].startswith(PROGRAM):
            program.append((lo, hi, e["name"]))
    forward: Dict[object, float] = {}
    for found in ops.values():
        if any(name.startswith(BACKWARD) for _, _, name, _ in found):
            continue
        for lo, _, _, seq in found:
            if seq is not None and lo < forward.get(seq, float("inf")):
                forward[seq] = lo

    def span_at(ts):
        inside = [(hi - lo, name) for lo, hi, name in program
                  if lo <= ts <= hi]
        return min(inside)[1] if inside else "no span"

    nests = {tid: _Nest(found) for tid, found in ops.items()}
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(
        float))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        kernel = next((k for k in kernels if k in e["name"]), None)
        if kernel is None:
            continue
        at = launches.get((e.get("args") or {}).get("correlation"))
        owner = "no launch traced"
        if at is not None:
            ts, tid = at
            chain = nests[tid].around(ts) if tid in nests else []
            span = span_at(ts)
            if chain and chain[-1][2].startswith(BACKWARD) \
                    and chain[-1][3] in forward:
                span += " < " + span_at(forward[chain[-1][3]])
            owner = " | ".join([span, chain[-1][2] if chain else "no op",
                                chain[0][2] if chain else "no op"])
        out[kernel][owner] += float(e["dur"]) * 1e-6
    return {k: dict(v) for k, v in out.items()}

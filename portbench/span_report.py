"""One traced run of a cell, and where its time went by the program's
spans:

    python3 -m portbench.span_report --workload NAME --seed N --seconds S \
        --out report.json

runs ``portbench.run`` with ``--trace 1`` (its result line printed as
usual) and writes a JSON report of the traced segment: the window, the
card's busy and idle time, the idle time inside each train phase and the
two remainders (``spans.py``), each span's host time per traced unit, and
the launcher of the largest device operations and of ``KERNELS``: the
span, and the outermost and innermost host op, found through the trace's
correlation ids (``spans.owners``).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from . import run, spans, synth_cell, train_cell

# device operations to attribute besides the largest ones
KERNELS = ("gemm_cf32cf32", "dgrad_engine", "direct_copy",
           "bfloat16_copy", "nchwToNhwc")
LARGEST = 8


def report(seg, events) -> dict:
    by_span = defaultdict(float)
    for name, _, dur in seg.host_ops:
        if name.startswith(spans.PROGRAM):
            by_span[name] += dur
    by_kernel = defaultdict(float)
    for name, _, dur in seg.device_ops:
        by_kernel[name] += dur
    largest = sorted(by_kernel, key=lambda k: -by_kernel[k])[:LARGEST]
    idle = {phase: spans.phase_idle_pct(seg, phase)
            for phase in spans.PHASES}
    idle.update(spans.remainders_pct(seg) or {})
    idle["all"] = 100.0 * (1.0 - seg.busy_s() / seg.window_s)
    idle.update({name: spans.idle_pct(seg, [name]) for name in by_span})
    idle["outside_spans"] = spans.idle_pct(seg, None, list(by_span))
    return {
        "units": seg.units, "window_s": seg.window_s, "busy_s": seg.busy_s(),
        "idle_pct": idle,
        "span_ms_per_unit": {k: 1e3 * v / seg.units
                             for k, v in sorted(by_span.items())},
        "span_counts": {k: len(spans.durations(seg, k)) for k in by_span},
        "device_s": {k[:120]: by_kernel[k] for k in largest},
        "owners": spans.owners(events, [*KERNELS, *largest]),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.span_report")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)
    held = []

    def keep(events, units, calls):
        seg = segment(events, units, calls)
        held.append((seg, events))
        return seg

    segment = train_cell.segment
    train_cell.segment = synth_cell.segment = keep
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        train_cell.segment = synth_cell.segment = segment
    if rc != 0 or not held:
        return rc or 1
    out = report(*held[0])
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"idle_pct": out["idle_pct"]}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

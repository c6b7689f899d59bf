"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up (weights drawn on the card, kernels
built, the cell's shapes warmed up) is timed from the process's start; then
the window measures for ``--seconds``; then the outputs are checked against
the plain reference in ``portbench/reference``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``compared``, and the last lines of standard error give each number compared
beside its limit.  Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library loads JAX or flax on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


_environment()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from . import card, registry  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def compared(numbers: dict, limits: dict) -> dict:
    """Each number the cell's limits name, with its limit.  A number that
    is not finite, or that the run did not read, reads 1e300 (the JSON line
    holds numbers only), so it fails its limit."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, (math.inf, None))[0]
        out[name] = {"value": value if math.isfinite(value) else 1e300,
                     "limit": limit}
    return out


def result_line(cell, out: dict, trace: bool) -> dict:
    numbers = compared(out["numbers"], cell.limits)
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    metrics = {}
    if trace:
        read = registry.readers(cell)
        for m in cell.per_layer:
            value = read[m["name"]](out["segment"], out["host"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = card.describe(cell.chips, out["peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        seg = out["segment"]
        device.update(busy_s=seg.busy_s(), window_s=seg.window_s)
        line["breakdown"] = seg.breakdown()
    line["readings"] = dict(out["readings"], at={
        name: where for name, (_, where) in out["numbers"].items()},
        not_compared={name: value for name, (value, _) in
                      out["numbers"].items() if name not in cell.limits})
    line["compared"] = numbers
    return line


def finish(cell, out: dict, trace: bool) -> int:
    """Reduce a run's output to its result line and print it, unless a
    module of JAX or of the JAX package is loaded by then (the per-layer
    readers included): then no result, and a non-zero exit."""
    line = result_line(cell, out, trace)
    bad = card.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, v in line["compared"].items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r} "
              f"({line['readings']['at'].get(name, 'not read')})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    cell = registry.cell(args.workload)
    try:
        device = card.require(cell.chips)
    except card.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    out = registry.kind(cell).run(cell, args.seed, args.seconds,
                                  bool(args.trace), device, T_START)
    return finish(cell, out, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())

"""Run the patch-staging probes on the card and report one status each.

    python -m stylish_tts_tpu_torch.scripts.mosaic_probe [--probe all|a,b]
        [--device cpu]

Each probe assembles six shifted [256, 32] slices into a [256, 192] patch
matrix (an im2col tile) by one way of staging data on Hopper, and two of
them multiply it by w [192, 128]; ``mini_kernel`` is a miniature of the
spec-conv forward.  ``csrc/patch_probe.cu`` says which idiom each kernel
tries.  The probes, their names, their inputs and their checks are those of
the TPU probe script (``scripts/mosaic_probe.py``): each runs one case and
checks it against numpy.  The report is one JSON object of ``"ok"``,
``"WRONG_NUMERICS"`` or ``"FAIL: ..."`` per probe; the exit code is 1 when
any probe is not ``"ok"``.

The probes run on ``cuda`` unless ``--device cpu`` is given (then every
wrapper takes its plain version); without a card the run raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import patch_probe as pp

T, CIN, TAPS = 256, 32, 6  # tile rows, channels, slices to assemble
PROBES = [
    "concat_full_lane", "concat_lane_off", "scratch_write",
    "stack_reshape", "dma_assemble", "matmul_after_concat",
    "matmul_after_scratch", "mini_kernel",
]


def ref_patches(x: np.ndarray) -> np.ndarray:
    # x: [T + TAPS, CIN] -> P [T, TAPS*CIN], col j = x[j + 0:T]
    return np.concatenate([x[j:j + T] for j in range(TAPS)], axis=1)


def probe_concat_full_lane(x: torch.Tensor) -> torch.Tensor:
    return pp.concat_full_lane(x)


def probe_concat_lane_off(x: torch.Tensor) -> torch.Tensor:
    # slices at 32-lane offsets from a [T+TAPS, 2*CIN] paired layout
    xp = torch.cat([x, x * 2.0], dim=1)
    return pp.concat_lane_off(xp)


def probe_scratch_write(x: torch.Tensor) -> torch.Tensor:
    return pp.scratch_write(x)


def probe_stack_reshape(x: torch.Tensor) -> torch.Tensor:
    return pp.stack_reshape(x)


def probe_dma_assemble(x: torch.Tensor) -> torch.Tensor:
    return pp.dma_assemble(x)


def product_weights(device) -> torch.Tensor:
    """w [192, 128] of the two products, as the TPU probes draw it."""
    w = np.random.default_rng(0).standard_normal((TAPS * CIN, 128))
    return torch.from_numpy(w.astype(np.float32)).to(device)


def probe_matmul_after_concat(x: torch.Tensor):
    w = product_weights(x.device)
    return pp.matmul_after_concat(x, w), w


def probe_matmul_after_scratch(x: torch.Tensor):
    w = product_weights(x.device)
    return pp.matmul_after_scratch(x, w), w


def mini_inputs(rows: int = 2 * T):
    """xq [2, 5, rows + 8, 128] and w [1728, 128], in the TPU probe's order
    (its own size: 512 rows)."""
    rng = np.random.default_rng(1)
    xq = rng.standard_normal((2, 5, rows + 8, 128)).astype(np.float32)
    w = rng.standard_normal((pp.MINI_K, 128)).astype(np.float32) * 0.1
    return xq, w


def mini_reference(xq: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The TPU probe's numpy reference, tile by tile."""
    b_n, fq_n, rows = xq.shape[0], xq.shape[1] - 2, xq.shape[2] - 8
    want = np.zeros((b_n, fq_n, rows, 128), np.float32)
    for b in range(b_n):
        for fq in range(fq_n):
            for tb in range(rows // T):
                tile = xq[b, fq:fq + 3, tb * T:tb * T + T + 8]
                cols = []
                for g in pp.MINI_GROUPS:
                    blk, lane = divmod(g, 4)
                    for dt in range(pp.MINI_KT):
                        cols.append(tile[blk, dt:dt + T,
                                         lane * CIN:(lane + 1) * CIN])
                want[b, fq, tb * T:(tb + 1) * T] = (
                    np.concatenate(cols, axis=1) @ w)
    return want


def probe_mini_kernel(x: torch.Tensor) -> str:
    """The miniature spec-conv forward against numpy."""
    xq, w = mini_inputs()
    y = pp.mini_kernel(torch.from_numpy(xq).to(x.device),
                       torch.from_numpy(w).to(x.device))
    got = y.cpu().numpy()
    want = mini_reference(xq, w)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want))) + 1e-9
    sys.stderr.write(f"mini_kernel rel err {err / scale:.3g}\n")
    return "ok" if err / scale < 2e-2 else f"WRONG_NUMERICS({err / scale:.3g})"


def run(names: List[str], device) -> Dict[str, str]:
    """Run the named probes on ``device``; one status per probe.  A probe
    that raises is reported as ``"FAIL: ..."`` and the rest still run."""
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((T + TAPS, CIN)).astype(np.float32)
    want = ref_patches(xh)
    x = torch.from_numpy(xh).to(device)

    results = {}
    for name in names:
        fn = globals()[f"probe_{name}"]
        try:
            if name == "mini_kernel":
                results[name] = fn(x)
                continue
            if name.startswith("matmul_after"):
                y, w = fn(x)
                got = y.cpu().numpy()
                exp = want @ w.cpu().numpy()
                d = np.abs(got - exp)
                ok = bool(np.allclose(got, exp, atol=1e-3))
                if not ok:
                    bad_r = np.where(d.max(1) > 1e-3)[0]
                    bad_c = np.where(d.max(0) > 1e-3)[0]
                    sys.stderr.write(
                        f"{name}: max={d.max():.3g} rows "
                        f"{bad_r[:6].tolist()}(n={len(bad_r)}) cols "
                        f"{bad_c[:6].tolist()}(n={len(bad_c)})\n")
            elif name == "concat_lane_off":
                got = fn(x).cpu().numpy()
                exp = np.concatenate(
                    [xh[j:j + T] * (1.0 + (j % 2)) for j in range(TAPS)],
                    axis=1)
                ok = bool(np.allclose(got, exp, atol=1e-5))
            else:
                ok = bool(np.allclose(fn(x).cpu().numpy(), want, atol=1e-5))
            results[name] = "ok" if ok else "WRONG_NUMERICS"
        except Exception as exc:  # noqa: BLE001 - reported, the rest run
            msg = str(exc).splitlines()
            results[name] = "FAIL: " + (msg[0][:160] if msg else repr(exc))
            traceback.print_exc(limit=2, file=sys.stderr)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="stylish_tts_tpu_torch.scripts.mosaic_probe")
    parser.add_argument("--probe", default="all",
                        help="all, or a comma-separated list of probes")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    names = PROBES if args.probe == "all" else args.probe.split(",")
    unknown = sorted(set(names) - set(PROBES))
    if unknown:
        parser.error(f"unknown probes {unknown}; choose from {PROBES}")
    results = run(names, resolve_device(args.device))
    print(json.dumps(results, indent=1))
    return 0 if all(v == "ok" for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

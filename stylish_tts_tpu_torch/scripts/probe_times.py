"""Device times of the patch-staging probe kernels, beside the plain
version, one library call for the same function and the bound.

    python -m stylish_tts_tpu_torch.scripts.probe_times [--out FILE]

The eight probe kernels (``csrc/patch_probe.cu``) run at the probe
script's sizes and inputs (T = 256); the five copies #4-8 and the two
products #9-10 also at T = 131072, where P (100.7 MB) is larger than the
50 MB L2, so bytes set the copies' time and operations the products'
(6.44 GFLOP, 96.2 us at the f32 peak, against 84.0 MB, 25.1 us), and
with them the mini kernel #11 at R = 8192 rows, where its blocks walk many
row tiles (21.7 GFLOP, 324.5 us, against 68.0 MB, 20.3 us).  Each
kernel is first held against its plain version (the copies bit for bit,
the products within 1e-5 of the largest value) and the library call
against it, then timed by torch.profiler (the kernels' own durations,
without the host's launch).  One line per kernel and shape, then the
device time of a one-element ``fill_``, the floor of any launch, then one
JSON object of all numbers.  Runs on the card only.

To time another checkout's kernels with the same ruler, put that checkout
first on the path: ``PYTHONPATH=<checkout> python <this file>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stylish_tts_tpu_torch.scripts.spec_conv_times import device_ms

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# rows of P at which the copies move more bytes than the L2 holds, and the
# products do operations enough that they, not the launch, set the time
LARGE_T = 131072
# the mini kernel's rows R: the probe script's 512 at its T = 256, and
# 8192 at LARGE_T, where its blocks walk many row tiles
MINI_ROWS = {256: 512, LARGE_T: 8192}


class Case(NamedTuple):
    """One kernel's inputs, its plain version, one library call for the same
    function, that call's output in the plain version's layout, and the
    function's FLOP and bytes (each input read once, the output written
    once)."""

    inputs: Tuple[torch.Tensor, ...]
    plain: Callable
    library: Callable
    as_plain: Callable
    flops: float
    nbytes: float

    def bound(self) -> Tuple[float, str]:
        """The least time in ms the card could take, and what sets it."""
        t_ops = self.flops / PEAK_F32_FLOPS * 1e3
        t_bytes = self.nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def mini_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """The mini kernel's w [1728, 128] as a conv2d kernel [128, 128, 3, 9]
    over (frequency block, t), zero outside the groups it reads."""
    from stylish_tts_tpu_torch.ops import patch_probe as pp

    full = torch.zeros(128, 128, 3, pp.MINI_KT, device=w.device)
    for gi, g in enumerate(pp.MINI_GROUPS):
        blk, lane = divmod(g, 4)
        for dt in range(pp.MINI_KT):
            rows = w[pp.CIN * (pp.MINI_KT * gi + dt):][:pp.CIN]
            full[:, pp.CIN * lane:pp.CIN * (lane + 1), blk, dt] = rows.T
    return full


def probe_cases(device, t: int) -> dict:
    """{kernel: Case} at ``t`` rows of P: the five copies and the two
    products, x and w drawn as the probe script draws them, and at the
    probe script's T and at LARGE_T the mini kernel too, at
    ``MINI_ROWS[t]`` rows (at T its inputs are the probe script's)."""
    from stylish_tts_tpu_torch.ops import patch_probe as pp
    from stylish_tts_tpu_torch.scripts import mosaic_probe as mp

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (t + mp.TAPS, mp.CIN)).astype(np.float32)).to(device)
    xp = torch.cat([x, x * 2.0], dim=1)

    def patches_lib():  # the rows overlap: a view until .contiguous()
        return x.as_strided((t, pp.K), (mp.CIN, 1)).contiguous()

    def lane_off_lib():
        return xp.as_strided((t, 3, 2, mp.CIN), (64, 128, 96, 1)
                             ).reshape(t, pp.K)

    p_bytes = 4.0 * (x.numel() + t * pp.K)
    cases = {pp.concat_lane_off: Case(
        (xp,), pp.lane_off_plain, lane_off_lib, torch.asarray, 0.0,
        4.0 * (xp.numel() + t * pp.K))}
    for k in (pp.concat_full_lane, pp.scratch_write, pp.stack_reshape,
              pp.dma_assemble):
        cases[k] = Case((x,), pp.patches_plain, patches_lib, torch.asarray,
                        0.0, p_bytes)

    w = mp.product_weights(device)
    x_ncl = x[:t + mp.TAPS - 1].T[None].contiguous()  # the rows P reads
    w_conv = w.view(mp.TAPS, mp.CIN, 128).permute(2, 1, 0).contiguous()

    def matmul_lib():
        return F.conv1d(x_ncl, w_conv)

    mm = Case((x, w), pp.matmul_plain, matmul_lib, lambda y: y[0].T,
              2.0 * t * pp.K * 128,
              4.0 * (x.numel() + w.numel() + t * 128))
    cases[pp.matmul_after_concat] = cases[pp.matmul_after_scratch] = mm
    if t in MINI_ROWS:
        xq, wq = (torch.from_numpy(a).to(device)
                  for a in mp.mini_inputs(MINI_ROWS[t]))
        xq_nchw = xq.permute(0, 3, 1, 2)  # a channels-last view
        wq_conv = mini_conv_weight(wq)

        def mini_lib():
            return F.conv2d(xq_nchw, wq_conv)

        b, fq, rows = xq.shape[0], xq.shape[1] - 2, xq.shape[2] - 8
        cases[pp.mini_kernel] = Case(
            (xq, wq), pp.mini_plain, mini_lib,
            lambda y: y.permute(0, 2, 3, 1),
            2.0 * b * fq * rows * pp.MINI_K * 128,
            4.0 * (xq.numel() + wq.numel() + b * fq * rows * 128))
    return {k: cases[k] for k in pp.KERNELS if k in cases}


def check_case(kernel, case: Case) -> dict:
    """One launch of ``kernel`` held against its plain version (the copies
    bit for bit; the products, f32 sums of 192 or 1728 products in another
    order, within 1e-5 of the largest value) and the library call within
    1e-3 of it; raises otherwise."""
    before = kernel.launches
    got = kernel(*case.inputs)
    if kernel.launches != before + 1:
        raise AssertionError(f"{kernel.name}: the wrapper did not launch")
    want = case.plain(*case.inputs)
    lib = case.as_plain(case.library())
    torch.cuda.synchronize()
    if got.shape != want.shape or lib.shape != want.shape:
        raise AssertionError(f"{kernel.name}: {tuple(got.shape)}, library "
                             f"{tuple(lib.shape)} vs {tuple(want.shape)}")
    scale = want.abs().max().item()
    if case.flops == 0:
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel.name} {tuple(got.shape)}: not "
                                 "bit-equal to the plain version")
        err = 0.0
    else:
        err = (got - want).abs().max().item()
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{kernel.name}: max err {err:.3e} > "
                                 f"{1e-5 * scale:.3e}")
    lib_err = (lib - want).abs().max().item()
    if not lib_err <= 1e-3 * scale:
        raise AssertionError(f"{kernel.name}: the library call is off by "
                             f"{lib_err:.3e}")
    return {"shapes": [list(a.shape) for a in case.inputs],
            "max_abs_err": err, "max_abs_plain": scale,
            "library_err": lib_err}


def device_times(kernel, case: Case) -> dict:
    """Device ms of the kernel, its plain version and the library call, the
    bound, and the bound's share of the kernel's device time."""
    kernel_ms = device_ms(lambda: kernel(*case.inputs))
    bound, by = case.bound()
    return {"device_ms": kernel_ms,
            "plain_device_ms": device_ms(lambda: case.plain(*case.inputs)),
            "library_device_ms": device_ms(case.library),
            "bound_ms": bound, "bound_by": by,
            "bound_share": bound / kernel_ms,
            "flops": case.flops, "bytes": case.nbytes}


def probe_times(device, t: int) -> dict:
    """{kernel name: checks and device times} of every case at ``t``."""
    out = {}
    for kernel, case in probe_cases(device, t).items():
        out[kernel.name] = {**check_case(kernel, case),
                            **device_times(kernel, case)}
    return out


def launch_floor_ms(device) -> float:
    """Device time of one tiny library kernel, a one-element ``fill_``:
    the floor under any launch, whatever its work."""
    tiny = torch.empty(1, device=device)
    return device_ms(lambda: tiny.fill_(1.0))


def times_line(name: str, n: dict) -> str:
    """One kernel's device times as printed, in microseconds."""
    return (f"{name} {n['shapes']}: device {n['device_ms'] * 1e3:.2f} us, "
            f"plain {n['plain_device_ms'] * 1e3:.2f}, library "
            f"{n['library_device_ms'] * 1e3:.2f}, bound "
            f"{n['bound_ms'] * 1e3:.3f} us ({n['bound_by']}, "
            f"{100 * n['bound_share']:.1f}% of the kernel's time), max err "
            f"{n['max_abs_err']:.2e} of {n['max_abs_plain']:.2e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_times: CUDA is not available", file=sys.stderr)
        return 1
    import stylish_tts_tpu_torch
    from stylish_tts_tpu_torch.device import resolve_device
    from stylish_tts_tpu_torch.scripts import mosaic_probe as mp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; package {stylish_tts_tpu_torch.__file__}")
    device = resolve_device("cuda")  # f32 products and convs, no TF32
    record = {"card": card}
    for t in (mp.T, LARGE_T):
        record[f"T={t}"] = probe_times(device, t)
        for name, n in record[f"T={t}"].items():
            print(f"T={t} {times_line(name, n)} [{card}]")
        torch.cuda.empty_cache()
    record["launch_floor_ms"] = launch_floor_ms(device)
    print(f"launch floor: a one-element fill_ takes "
          f"{record['launch_floor_ms'] * 1e3:.2f} us of device time [{card}]")
    line = json.dumps(record)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

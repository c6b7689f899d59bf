"""Device times of the MRD's spec-conv kernels at the train step's layer
shapes, beside cuDNN's bf16 call for the same function.

    python -m stylish_tts_tpu_torch.scripts.spec_conv_times [--out FILE]

For each of the 12 spec-conv layers of the MRD at b8 x f460 (three
resolutions, conv_1..conv_4), the forward, dgrad and wgrad kernels are held
against their plain versions and timed by torch.profiler (the kernels' own
durations, without the host's launch; the wgrad also by kernel function,
its main kernel and its partial sum).  One line per kernel and shape, then
each kernel's total over its launches in a train step (48 forward, 36
dgrad, 24 wgrad) beside cuDNN's, and one JSON object of all numbers.
Inputs are made on the card from fixed seeds.  Runs on the card only.

To time another checkout's kernels with the same ruler, put that checkout
first on the path: ``PYTHONPATH=<checkout> python <this file>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

# the train step's batch: 8 x 460 frames of 300 samples
BATCH, SAMPLES = 8, 138_000
# conv_1..conv_4: (kt, stride)
MRD_CONVS = [(9, 2), (9, 2), (9, 2), (3, 1)]
# each layer runs the forward 4 times a train step: real and generated
# input, in the discriminator's and the generator's pass
FWD_LAUNCHES_PER_LAYER = 4
# ... and the wgrad twice: real and generated input in the discriminator's
# pass (the generator's pass needs no weight gradient of the MRD)
WGRAD_LAUNCHES_PER_LAYER = 2
# ... and the dgrad 3 times: real and generated input in the
# discriminator's pass, generated input in the generator's (the real
# audio needs no input gradient there)
DGRAD_LAUNCHES_PER_LAYER = 3
# the launches of each kernel in a train step, per layer
LAUNCHES_PER_LAYER = {"forward": FWD_LAUNCHES_PER_LAYER,
                      "dgrad": DGRAD_LAUNCHES_PER_LAYER,
                      "wgrad": WGRAD_LAUNCHES_PER_LAYER}
# the wgrad's kernel functions, as the profiler names them
WGRAD_FUNCTIONS = ("spec_conv_wgrad_kernel", "sum_partials_kernel")
# bf16 outputs: one bf16 rounding of f32 sums taken in another order; the
# f32 weight gradient: sums of millions of bf16 products in another order
TOL = {"forward": 1e-2, "dgrad": 1e-2, "wgrad": 1e-3}


def mrd_layers(batch: int = BATCH, samples: int = SAMPLES
               ) -> List[Tuple[str, Tuple[int, int, int, int], int, int]]:
    """(label, x shape [B, H, W, 32], kt, stride) of every spec-conv layer
    on a batch of ``batch`` x ``samples`` audio: per resolution of
    ``ops/multi_spectrogram.py`` the |STFT| image has n_fft // 2 + 1 rows
    and samples // hop + 1 frames (a centred STFT)."""
    from stylish_tts_tpu_torch.ops.multi_spectrogram import RESOLUTIONS

    layers = []
    for res, r in enumerate(RESOLUTIONS):
        f, w = r.fft // 2 + 1, samples // r.hop + 1
        for i, (kt, stride) in enumerate(MRD_CONVS, 1):
            layers.append((f"res{res} conv_{i}", (batch, f, w, 32), kt,
                           stride))
            w = -(-w // stride)
    return layers


#: the key of a time taken by CUDA events where the profiler saw nothing
EVENTS_KEY = "cuda events (no profiler record)"


def device_ms_by_kernel(fn: Callable, iters: int = 20,
                        attempts: int = 5) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler,
    ``iters`` calls): each kernel's mean duration times its launches per
    call, its records over ``iters`` rounded to a whole number (a kernel
    that runs in fewer than half the calls keeps the fraction).  Now and
    then a profiler session records no device time, or loses some of a
    kernel's records (its launches are then no multiple of ``iters``): such
    a session is taken again, up to ``attempts`` times; if none is whole,
    the fullest one is kept, with a note on stderr, and its means stand for
    the lost records.  Where no session records any device time, the
    mean span of ``iters`` back-to-back calls between two CUDA events
    stands in, under the key ``EVENTS_KEY``, with a note on stderr: an
    upper bound, the host's launch gaps included."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    fullest, most = {}, 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and evt.count > 0]
        times = {evt.key: evt.self_device_time_total / 1e3 / evt.count
                 * (round(evt.count / iters) or evt.count / iters)
                 for evt in events}
        if sum(times.values()) > 0 and all(evt.count % iters == 0
                                           for evt in events):
            return times
        records = sum(evt.count for evt in events)
        if records > most:
            fullest, most = times, records
    if sum(fullest.values()) <= 0:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        print(f"device_ms: torch.profiler recorded no device time in "
              f"{attempts} sessions; CUDA events instead: {ms:.4f} ms",
              file=sys.stderr)
        return {EVENTS_KEY: ms}
    print(f"device_ms: no profiler session of {attempts} recorded every "
          f"launch; keeping the fullest ({most} records of {iters} calls)",
          file=sys.stderr)
    return fullest


def device_ms(fn: Callable, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, summed."""
    return sum(device_ms_by_kernel(fn, iters).values())


def by_function(times: dict, functions) -> dict:
    """``times`` by kernel name summed by the function each name holds."""
    out = {f: 0.0 for f in functions}
    for key, ms in times.items():
        for f in functions:
            if f in key:
                out[f] += ms
    return out


def conv_calls(shape, kt: int, stride: int, seed: int) -> dict:
    """Inputs made on the card from ``seed`` for one layer shape, and for
    each kernel (forward, dgrad, wgrad) three calls on them: the kernel's
    wrapper, its plain version and cuDNN's bf16 call."""
    from stylish_tts_tpu_torch.ops import spec_conv as sc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape
    w_out = sc.out_width(w, stride)

    def randn(*size, scale=1.0):
        return (scale * torch.randn(size, generator=gen, device="cuda")
                ).bfloat16()

    x = randn(b, h, w, c)
    wt = randn(c, c, 3, kt, scale=(3 * kt * c) ** -0.5)
    bias = randn(c, scale=0.1)
    d = randn(b, h, w_out, c)
    pad = (1, kt // 2)
    x_cl, d_cl = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)  # NHWC views
    return {
        "forward": (lambda: sc.spec_conv_forward(x, wt, bias, stride, 0.1),
                    lambda: sc.forward_plain(x, wt, bias, stride, 0.1),
                    lambda: F.conv2d(x_cl, wt, bias, stride=(1, stride),
                                     padding=pad)),
        "dgrad": (lambda: sc.spec_conv_dgrad(d, wt, w, stride),
                  lambda: sc.dgrad_plain(d, wt, w, stride),
                  lambda: torch.nn.grad.conv2d_input(
                      (b, c, h, w), wt, d_cl, stride=(1, stride),
                      padding=pad)),
        "wgrad": (lambda: sc.spec_conv_wgrad(x, d, kt, stride),
                  lambda: sc.wgrad_plain(x, d, kt, stride),
                  lambda: torch.nn.grad.conv2d_weight(
                      x_cl, (c, c, 3, kt), d_cl, stride=(1, stride),
                      padding=pad)),
    }


def max_error(name: str, shape, got: torch.Tensor,
              want: torch.Tensor) -> tuple:
    """(max |got - want|, max |want|); raises beyond ``TOL[name]``."""
    if got.shape != want.shape:
        raise AssertionError(f"spec_conv_{name} {shape}: "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not err <= TOL[name] * scale:
        raise AssertionError(f"spec_conv_{name} {shape}: max err "
                             f"{err:.3e} > {TOL[name]} * {scale:.3e}")
    return err, scale


def layer_times(shape, kt: int, stride: int, seed: int,
                kernels=("forward",)) -> dict:
    """Each of ``kernels`` at one layer shape: its max error against the
    plain version, its device time and cuDNN's."""
    calls = conv_calls(shape, kt, stride, seed)
    out = {}
    for name in kernels:
        kernel, plain, library = calls[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, scale = max_error(name, shape, got, want)
        del got, want
        times = device_ms_by_kernel(kernel)
        out[name] = {"max_abs_err": err, "max_abs_plain": scale,
                     "device_ms": sum(times.values()),
                     "library_device_ms": device_ms(library)}
        if name == "wgrad":
            out[name]["function_device_ms"] = by_function(times,
                                                          WGRAD_FUNCTIONS)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("spec_conv_times: CUDA is not available", file=sys.stderr)
        return 1
    import stylish_tts_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; package {stylish_tts_tpu_torch.__file__}")
    record = {"card": card, "layers": {}}
    per_step = LAUNCHES_PER_LAYER
    totals = {name: {"kernel": 0.0, "cudnn": 0.0} for name in per_step}
    for seed, (label, shape, kt, stride) in enumerate(mrd_layers()):
        r = layer_times(shape, kt, stride, 100 + seed, tuple(per_step))
        record["layers"][label] = {"shape": list(shape), "kt": kt,
                                   "stride": stride, **r}
        for name, n in per_step.items():
            totals[name]["kernel"] += n * r[name]["device_ms"]
            totals[name]["cudnn"] += n * r[name]["library_device_ms"]
        for name, n in r.items():
            split = "".join(f", {f} {ms:.4f}" for f, ms in
                            n.get("function_device_ms", {}).items())
            print(f"spec_conv_{name} {label} {shape} kt={kt} s={stride}: "
                  f"device {n['device_ms']:.4f} ms{split}, cuDNN bf16 "
                  f"{n['library_device_ms']:.4f} ms, max err "
                  f"{n['max_abs_err']:.2e} of {n['max_abs_plain']:.2e} "
                  f"[{card}]")
        torch.cuda.empty_cache()
    for name, n in per_step.items():
        record[f"{name}_step_ms"] = totals[name]
        print(f"spec_conv_{name} over a train step's "
              f"{n * len(mrd_layers())} launches: kernel "
              f"{totals[name]['kernel']:.3f} ms, cuDNN bf16 "
              f"{totals[name]['cudnn']:.3f} ms [{card}]")
    line = json.dumps(record)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:

1. device and build: the card's name and power limit, CUDA version, and
   the build of every kernel source of the port (``csrc/*.cu``, one
   ``nvcc`` each, started together), with the compiler's register and
   spill report;
2. kernels vs plain: the STFT kernel on random f32 input at its shapes, and
   the MRD's spec-conv forward, dgrad and wgrad kernels at three of the
   MRD's real layer shapes (b8 x f460), each held against its plain
   PyTorch version, with its time, the plain version's, a library call's
   (a yardstick the port never calls) and its bound; each kernel and its
   library call also with their device time by torch.profiler, which
   leaves out the host's launch; then the spec-conv forward, dgrad and
   wgrad at all 12 layer shapes of the MRD at b8 x f460, each held against
   its plain version, with its and cuDNN's device time (the wgrad's also
   split between its main kernel and its partial sum) and their totals over
   the launches of a train step;
3. probes: the eight patch-staging probe kernels (``csrc/patch_probe.cu``)
   at the probe script's sizes and inputs, each held against its plain
   version (the five copies exactly, the three products within
   1e-5 of the largest value) and timed beside it, its library call and its
   bound; then the five copies and the two products at T = 131072, where
   bytes set the copies' time and operations the products' (6.44 GFLOP,
   96.2 us at the f32 peak), and the mini kernel at R = 8192 rows (21.7
   GFLOP, 324.5 us), held against the plain version as at T = 256,
   with their, the plain version's and the library call's device time and
   the bound's share; then the probe entry point
   (``stylish_tts_tpu_torch.scripts.mosaic_probe.run``) on the card, with
   the launch counts set to 0 just before and read just after: every probe
   "ok", every probe kernel launched;
4. synthesis: ``Synthesizer`` at the default full-width ModelConfig with
   seeded random weights serves one ``synthesize`` of 80 phonemes and one
   ``synthesize_batch`` of 8 utterances, with the allocator's new
   segments in each request; the launch counts are set to 0
   just before and read just after, and the audio is checked (finite, not
   silent, exactly total_frames * hop samples); the STFT kernel is held
   against its plain version at this path's shapes, and the CPU and card
   outputs of the full-width models are compared on a short input;
5. training: the acoustic-stage train state at
   the full-width ModelConfig and the default Config (bf16 mixed
   precision, 12-layer frozen SLM from a seed) takes one warm-up step and
   3 timed steps on one synthetic batch of 8 x 460 mel frames; the launch
   counts are set to 0 before the timed steps and read after; the metrics
   are finite, every train model and the MRD moved, the discriminator EMA
   changed and every kernel launched, the spec-conv forward, dgrad and
   wgrad as often as the MRD's 12 layers give; then one f32 step at full
   width on 1 x 64 frames runs on the CPU and on the card from the same
   weights and their metrics are compared;
6. training runtime: at the same width, a synthetic dataset of 158 train
   segments of 0.7-1.3 x 5.75 s (460 frames) is written to disk, a
   ``BatchManager`` (``probe_batch_max=8``: the bin of 460 frames takes
   batches of 8) times its producer's decode and collate of one full
   batch beside phase 5's warm step, then feeds 4 acoustic steps on the
   card from its epoch iterator (each step's wall ms and data wait
   printed; the last step profiled, which must name the STFT kernel and
   the three spec-conv kernels); after 2 steps a checkpoint is saved and
   loaded into a state drawn from another seed (every tensor and the
   generator state equal), and step 3 resumed from it with
   ``skip_batches=2`` must give the uninterrupted step 3's metrics
   exactly; then the checkpoint is packaged as an inference artifact,
   loaded on the card and one ``synthesize`` of 80 phonemes from it is
   checked as in phase 4; the launch counts are set to 0 before the first
   step and read after the synthesis; checkpoint bytes and save, load and
   package seconds printed; last, at every batch shape the steps took,
   the STFT at its five settings and the spec-conv forward, dgrad and
   wgrad at the MRD's 12 layer shapes are held against their plain
   versions as in phase 2;
7. the training chain: CLI ``train`` in-process at the full-width
   default ModelConfig on a synthetic dataset on disk (96 train and 8 val
   segments of about 5.9 s, over 3 bins), each stage of acoustic ->
   textual -> style -> duration at 1 epoch, the measured memory plan on
   (``memory_budget_mib`` 85% of the card's memory), a validation and a
   save every 3 steps; a hook at each stage's start, after its memory
   plan and at its end sets the launch counts to 0, holds the state after
   the probe equal to the state before it (every tensor), and reads the
   counts and which models moved.  Checked: the chain's order, each
   stage's ``checkpoint_final`` and manifest counters, every trained model
   moved and every other one bit-equal (the MRD moves only in acoustic
   and textual), finite metrics and validation losses, the persisted
   plan (measured, or kept where the fit is degenerate, as for the light
   style and duration stages), the STFT launched in every stage and the spec-conv kernels only
   in acoustic and textual, as often as the MRD's 12 layers give; then at
   every batch shape textual took the STFT and the spec-conv kernels are
   held against their plain versions as in phase 6; last ``convert`` and
   ``speak`` through the CLI's ``main`` on the last checkpoint, and 80
   phonemes from the artifact checked as in phase 4.  Per stage: the
   probe's seconds and fit, each step's wall ms (first visit of its
   shape in the stage, or warm), validation and save seconds;
8. one JSON line of every kernel's numbers, with its launches on the path
   that runs it (per train step, synthesis request or probe run), then the
   result line.

``--profile`` adds torch.profiler breakdowns of one batch request and of
one train step: device time by kernel, the port's own kernels' totals,
and the device's busy share of the wall time.

Numbers beyond the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stylish_tts_tpu_torch.scripts.probe_times import (
    LARGE_T, MINI_ROWS, check_case, device_times, probe_cases, probe_times,
    times_line)
from stylish_tts_tpu_torch.scripts.spec_conv_times import (
    LAUNCHES_PER_LAYER, conv_calls, device_ms, layer_times, max_error,
    mrd_layers)

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TRAIN_BATCH, TRAIN_FRAMES = 8, 460
STFT_SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
               (2048, 240, 1200), (2048, 300, 1200)]
KERNEL_TOL = 1e-4  # max|kernel - plain| <= KERNEL_TOL * max|plain|
# the MRD's spec-conv layers at b8 x f460 (138,000 samples): res 0 conv_1
# (the largest), res 1 conv_1 (an odd width: a partial tile), res 2 conv_4;
# (label, [B, H, W, 32], kt, stride)
CONV_SHAPES = [("res0 conv_1", (8, 257, 2761, 32), 9, 2),
               ("res1 conv_1", (8, 513, 1151, 32), 9, 2),
               ("res2 conv_4", (8, 1025, 72, 32), 3, 1)]
# the port's kernel functions on the two model paths, as the profiler
# names them
PORT_KERNEL_SYMBOLS = ("stft_fft_kernel", "spec_conv_",
                       "sum_partials_kernel")
# relative bounds between two runs of one train step's metrics.  f32
# terms: the same f32 model on two devices, sums in another order; the MRD
# and the SLM run in bf16 on both, through cuDNN and the kernels on one and
# the CPU's convs on the other
STEP_TOL = {"mel": 1e-3, "mag": 1e-3, "phase": 1e-3, "pitch": 1e-3,
            "energy": 1e-3, "slm": 2e-2, "generator": 2e-2,
            "discriminator": 2e-2, "loss": 2e-3}
# the training runtime's phase: a synthetic dataset on disk of segments
# spread around the train step's 460 frames (158 train segments over 14
# bins, enough that the first batches an epoch takes are at their bins'
# planned sizes, the first one b8 x f460), steps fed by the epoch
# iterator, a checkpoint after RUNTIME_SAVE_AT of them; the kernels its
# profiled step must name (csrc/stft.cu, csrc/spec_conv.cu)
RUNTIME_SEGMENTS, RUNTIME_SECONDS = 160, 5.75
RUNTIME_STEPS, RUNTIME_SAVE_AT = 4, 2
RUNTIME_KERNELS = ("stft_fft_kernel", "spec_conv_fwd_kernel",
                   "spec_conv_dgrad_kernel", "spec_conv_wgrad_kernel")
# the training chain's phase: 104 segments of 0.9375-1.0625 x 5.875 s
# (440-498 frames), the last 8 the val set: 96 train over bins 21-23
# (480-520 frames), enough that a bin holds two full batches of the
# measured plan (13-15 at the acoustic stage, PR 15) and a stage meets a
# shape twice; every stage 1 epoch, a validation and a save every
# CHAIN_INTERVAL steps (a stage takes at least one batch a bin, so 3 steps
# or more, and validates and saves at least once), the memory budget a
# share of the card's memory
CHAIN = ("acoustic", "textual", "style", "duration")
CHAIN_SEGMENTS, CHAIN_VAL, CHAIN_SECONDS, CHAIN_SPREAD = \
    104, 8, 5.875, 0.0625
CHAIN_INTERVAL, CHAIN_BUDGET_SHARE = 3, 0.85


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` from CUDA events, after a warm-up.
    ``flush`` (a buffer larger than the 50 MB L2) is rewritten before each
    launch, outside the timed span, so each launch finds the cache cold."""
    fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --------------------------------------------------------------------------- #
# the STFT kernel


def stft_error(x: torch.Tensor, n_fft: int, hop: int, win: int) -> tuple:
    """The kernel's (real, imag) on ``x`` and its max error against the
    plain version; raises past KERNEL_TOL of the largest plain value or
    where the wrapper did not launch the kernel."""
    from stylish_tts_tpu_torch.ops import stft as plain
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    before = stft_forward.launches
    real, imag = stft_forward(x, **kw)
    if stft_forward.launches != before + 1:
        raise AssertionError("stft: the wrapper did not launch the kernel")
    r0, i0 = plain.stft(x, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for got, want, part in ((real, r0, "real"), (imag, i0, "imag")):
        if got.shape != want.shape:
            raise AssertionError(f"stft {part}: {got.shape} vs {want.shape}")
        e = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not e <= KERNEL_TOL * scale:
            raise AssertionError(f"stft {part} {tuple(x.shape)} n_fft={n_fft} "
                                 f"hop={hop}: max err {e:.3e} > {KERNEL_TOL} "
                                 f"* {scale:.3e}")
        err = max(err, e)
    return real, imag, err


def stft_numbers(x: torch.Tensor, n_fft: int, hop: int, win: int,
                 flush: torch.Tensor) -> dict:
    """Hold the kernel against the plain version on ``x`` and time both,
    torch.stft, and the bound."""
    from stylish_tts_tpu_torch.ops import stft as plain
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    real, imag, err = stft_error(x, n_fft, hop, win)

    # and against an independent algorithm: cuFFT through torch.stft
    window = plain._padded_window(win, n_fft).to(x.device)
    lib = torch.stft(x, n_fft, hop, n_fft, window, center=True,
                     pad_mode="reflect", return_complex=True).transpose(1, 2)
    lib_err = max((real - lib.real).abs().max().item(),
                  (imag - lib.imag).abs().max().item())
    if not lib_err <= KERNEL_TOL * lib.abs().max().item():
        raise AssertionError(f"stft n_fft={n_fft} hop={hop}: kernel vs "
                             f"torch.stft max err {lib_err:.3e}")
    ms = time_ms(lambda: stft_forward(x, **kw), flush=flush)
    plain_ms = time_ms(lambda: plain.stft(x, **kw), flush=flush)
    def library():
        return torch.stft(x, n_fft, hop, n_fft, window, center=True,
                          pad_mode="reflect", return_complex=True)

    library_ms = time_ms(library, flush=flush)
    # the device's own time, without the host's launch that the spans of
    # time_ms hold: most of a span at the smaller shapes
    kernel_device_ms = device_ms(lambda: stft_forward(x, **kw))
    library_device_ms = device_ms(library)

    # the least the card could take for this function: a real FFT of
    # n_fft points per frame, about 2.5 * n_fft * log2(n_fft) FLOP (half a
    # complex radix-2 FFT's 5 N log2 N), plus the window's n_fft products;
    # bytes are the signal and the window read once and (real, imag)
    # written once
    b, t = x.shape
    frames, freq = real.shape[1], real.shape[2]
    flops = b * frames * (2.5 * n_fft * np.log2(n_fft) + n_fft)
    nbytes = 4.0 * (b * t + n_fft + 2 * b * frames * freq)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    return {
        "shape": [b, t], "n_fft": n_fft, "hop": hop, "win": win,
        "max_abs_err": err, "err_vs_torch_stft": lib_err, "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_share": bound / ms, "device_ms": kernel_device_ms,
        "library_device_ms": library_device_ms, "flops": flops,
        "bytes": nbytes,
    }


def stft_line(r: dict) -> str:
    """One STFT record as printed: times, bound, share and errors."""
    return (f"kernel {r['ms']:.3f} ms [{r['device_ms']:.4f}], plain "
            f"{r['plain_ms']:.3f} ms, torch.stft {r['library_ms']:.3f} ms "
            f"[{r['library_device_ms']:.4f}], bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {100 * r['bound_share']:.1f}% of it; "
            f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of the device "
            f"time), max err {r['max_abs_err']:.2e} (vs torch.stft "
            f"{r['err_vs_torch_stft']:.2e})")


# --------------------------------------------------------------------------- #
# the spec-conv kernels


def conv_error(name: str, shape, kernel, plain) -> tuple:
    """(max |kernel - plain|, max |plain|) of one spec-conv wrapper call
    and its plain version; raises past the tolerance of ``max_error`` or
    where the wrapper did not launch its kernel."""
    from stylish_tts_tpu_torch.ops import spec_conv as sc

    counter = getattr(sc, f"spec_conv_{name}")
    before = counter.launches
    got = kernel()
    if counter.launches != before + 1:
        raise AssertionError(f"spec_conv_{name}: no kernel launch")
    want = plain()
    torch.cuda.synchronize()
    return max_error(name, shape, got, want)


def spec_conv_numbers(shape, kt: int, stride: int, flush: torch.Tensor,
                      seed: int) -> dict:
    """Forward, dgrad and wgrad at one MRD layer shape: each kernel held
    against its plain version and timed beside it, cuDNN's bf16
    channels-last call and its bound."""
    from stylish_tts_tpu_torch.ops import spec_conv as sc

    b, h, w, c = shape
    w_out = sc.out_width(w, stride)
    x_elems, d_elems, w_elems = b * h * w * c, b * h * w_out * c, 3 * kt * c * c
    nbytes = {"forward": 2 * (x_elems + w_elems + c + d_elems),
              "dgrad": 2 * (d_elems + w_elems + x_elems),
              "wgrad": 2 * (x_elems + d_elems) + 4 * w_elems}
    flops = 2.0 * b * h * w_out * 3 * kt * c * c
    out = {}
    for name, (kernel, plain, library) in conv_calls(
            shape, kt, stride, seed).items():
        err, scale = conv_error(name, shape, kernel, plain)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes[name] / PEAK_BYTES * 1e3
        ms = time_ms(kernel, flush=flush)
        out[name] = {
            "shape": list(shape), "kt": kt, "stride": stride,
            "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
            "plain_ms": time_ms(plain, iters=3, flush=flush),
            "library_ms": time_ms(library, flush=flush),
            # the device's own time, without the host's launch in the spans
            "device_ms": device_ms(kernel),
            "library_device_ms": device_ms(library),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes[name],
            "tflops_per_s": flops / ms * 1e-9,
        }
    return out


# --------------------------------------------------------------------------- #
# the patch-staging probes


def time_mean_ms(fn, iters: int = 100) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches
    between one pair of CUDA events, after a warm-up, with no L2 flush:
    the probes' inputs are a few hundred KB, which the cache holds anyway."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_numbers(device) -> dict:
    """Each probe kernel at the probe script's sizes and inputs: held
    against its plain version, timed beside it and one library call, by
    CUDA events and in device time, with its bound."""
    from stylish_tts_tpu_torch.scripts import mosaic_probe as mp

    out = {}
    for k, case in probe_cases(device, mp.T).items():
        out[k.name] = {
            **check_case(k, case),
            "ms": time_mean_ms(lambda: k(*case.inputs)),
            "plain_ms": time_mean_ms(lambda: case.plain(*case.inputs)),
            "library_ms": time_mean_ms(case.library),
            **device_times(k, case),
        }
    return out


def probe_run(device, kernels, card: str) -> dict:
    """The probe entry point on the card, its launch counts set to 0 just
    before and read just after."""
    from stylish_tts_tpu_torch.scripts import mosaic_probe as mp

    for k in kernels:
        k.launches = 0
    results = mp.run(mp.PROBES, device)
    launches = {k.name: k.launches for k in kernels}
    print(f"probe entry point on the card: {json.dumps(results)}; "
          f"launches {launches} [{card}]")
    bad = {n: r for n, r in results.items() if r != "ok"}
    if bad or list(results) != mp.PROBES:
        raise AssertionError(f"probes not ok: {bad or results}")
    for name, n in launches.items():
        if n != 1:
            raise AssertionError(f"{name}: {n} launches in one probe run")
    return {"results": results, "launches": launches}


# --------------------------------------------------------------------------- #
# the training path


def synthetic_batch(mc, batch: int, frames: int, seed: int):
    """One acoustic batch as numpy arrays: token strings drawn from the
    inventory, durations summing to ``frames`` with a one-hot alignment,
    F0 of 80-300 Hz with unvoiced stretches, and ground-truth audio that is
    a harmonic signal on that F0 plus noise."""
    from stylish_tts_tpu_torch.text import TextCleaner

    rng = np.random.default_rng(seed)
    counts = [int(n) for n in rng.integers(frames // 12, frames // 6, batch)]
    cleaner = TextCleaner(mc.symbol)
    texts = phoneme_strings(mc.symbol, counts, seed + 1)
    tokens = np.zeros((batch, max(counts)), np.int64)
    alignment = np.zeros((batch, max(counts), frames), np.float32)
    for i, (text, n) in enumerate(zip(texts, counts)):
        tokens[i, :n] = cleaner(text)
        cuts = np.sort(rng.choice(np.arange(1, frames), n - 1, replace=False))
        for t, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, frames])):
            alignment[i, t, lo:hi] = 1.0
    pitch = np.zeros((batch, frames), np.float32)
    for i in range(batch):
        t, voiced = 0, bool(rng.integers(2))
        while t < frames:
            run = int(rng.integers(10, 60))
            if voiced:
                pitch[i, t:t + run] = np.linspace(
                    *rng.uniform(80.0, 300.0, 2), len(pitch[i, t:t + run]))
            t, voiced = t + run, not voiced
    hop = mc.hop_length
    f0 = np.repeat(pitch, hop, axis=1)
    phase = 2 * np.pi * np.cumsum(f0 / mc.sample_rate, axis=1)
    audio = sum(0.3 / k * np.sin(k * phase) for k in range(1, 9)) * (f0 > 0)
    audio = audio + 0.01 * rng.standard_normal(audio.shape)
    return dict(text=tokens, text_length=np.array(counts, np.int64),
                alignment=alignment, pitch=pitch,
                audio_gt=audio.astype(np.float32))


def train_setup(mc, cfg, device, seed: int, models=None):
    from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)

    keys = STAGES["acoustic"].train_models + ["mrd"]
    gen = torch.Generator().manual_seed(seed)
    state = build_train_state(mc, keys, generator=gen, models=models,
                              device=device)
    slm = init_slm(mc, torch.Generator().manual_seed(seed + 1)).to(device)
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                       mel_std=4.0, step_limit=10_000, slm=slm)
    return state, make_train_step("acoustic", ctx, 1e-4)


def on_device(batch: dict, device) -> dict:
    """The arrays of a numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def train_path(mc, device, card: str, kernels) -> dict:
    """The full-width acoustic step on one batch of 8 x 460 frames: one
    warm-up step, then 3 timed steps with the launch counts zeroed before
    them."""
    from stylish_tts_tpu_torch.config import Config

    state, step = train_setup(mc, Config(), device, seed=10)
    batch = on_device(synthetic_batch(mc, TRAIN_BATCH, TRAIN_FRAMES, 11),
                      device)
    gen = torch.Generator(device=device).manual_seed(12)
    before = {k: [p.detach().clone() for p in m.parameters()]
              for k, m in state.models.items()}
    ema0 = state.disc_ema["mrd"].item()
    state, metrics = step(state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} never launched on the train step")
    values = {k: v.item() for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}: {values}")
    for key, params in before.items():
        moved = any(not torch.equal(a, b.detach()) for a, b in
                    zip(params, state.models[key].parameters()))
        if not moved:
            raise AssertionError(f"{key}: no parameter moved")
    if state.disc_ema["mrd"].item() == ema0:
        raise AssertionError("the discriminator EMA did not change")
    audio_s = TRAIN_BATCH * TRAIN_FRAMES * mc.hop_length / mc.sample_rate
    median = float(np.median(walls))
    if any(v % 3 for v in launches.values()):
        raise AssertionError(f"launches differ between the steps: {launches}")
    per_step = {k: v // 3 for k, v in launches.items()}
    print(f"train step (acoustic, bf16, b{TRAIN_BATCH} x f{TRAIN_FRAMES}): "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median "
          f"{median * 1e3:.1f} ms, {audio_s / median:.1f} audio s per s, "
          f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    print(f"train step launches per step: {per_step} [{card}]")
    print(f"train step metrics: "
          f"{json.dumps({k: round(v, 5) for k, v in values.items()})}")
    return {"wall_s": walls, "median_s": median, "audio_s": audio_s,
            "audio_s_per_s": audio_s / median, "peak_bytes": peak,
            "launches": launches, "launches_per_step": per_step,
            "metrics": values, "card": card}, state, step, batch, gen


def cpu_vs_card_step(mc, card: str) -> dict:
    """One f32 step at full width on 1 x 64 frames from the same weights
    on the CPU (plain versions) and on the card (kernels), dropout off,
    latent means instead of samples and the same prior noise."""
    import copy

    from stylish_tts_tpu_torch.config import Config
    from stylish_tts_tpu_torch.models.norms import Dropout
    from stylish_tts_tpu_torch.train.init import build_training_models
    from stylish_tts_tpu_torch.train.init import init_params

    cfg = Config()
    cfg.training.mixed_precision = "no"
    gen = torch.Generator().manual_seed(20)
    built = build_training_models(mc)
    models = {k: init_params(built[k], gen) for k in
              ("speech_predictor", "pitch_energy_predictor",
               "pe_text_encoder", "pe_mel_style_encoder", "mrd")}
    for model in models.values():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    batch = synthetic_batch(mc, 1, 64, 21)
    noise = np.random.default_rng(22).standard_normal(
        (1, 64 * mc.hop_length)).astype(np.float32)
    results = {}
    for device in ("cpu", "cuda"):
        state, step = train_setup(mc, cfg, device, seed=23,
                                  models=copy.deepcopy(models))
        _, metrics = step(state, on_device(batch, device), sample=False,
                          pcph_noise=torch.from_numpy(noise).to(device),
                          pcph_phase=torch.zeros(1, 1, device=device))
        results[device] = {k: v.item() for k, v in metrics.items()}
    rel = {}
    for key, bound in STEP_TOL.items():
        a, b = results["cpu"][key], results["cuda"][key]
        rel[key] = abs(a - b) / max(abs(a), 1e-30)
        if not rel[key] <= bound:
            raise AssertionError(f"train step cpu vs card {key}: {a} vs {b}")
    print(f"full-width train step f32 on 1 x 64 frames, cpu vs card: "
          f"relative differences {json.dumps(rel)} [{card}]")
    return {"metrics": results, "relative_difference": rel}


def profile_step(step, state, batch, gen, card: str) -> dict:
    """Device time by kernel over one train step (torch.profiler) and the
    device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_table(prof, wall_ms, "train step", card)


# --------------------------------------------------------------------------- #
# the training runtime: data on disk, checkpoint, resume, artifact


def _states_equal(a, b) -> int:
    """Assert two train states hold equal tensors (every parameter, buffer
    and optimizer tensor, the EMA, the step); returns how many tensors."""
    count = 0
    for key in a.models:
        sa, sb = a.models[key].state_dict(), b.models[key].state_dict()
        if sa.keys() != sb.keys():
            raise AssertionError(f"{key}: the loaded state has other names")
        for name in sa:
            if not torch.equal(sa[name], sb[name]):
                raise AssertionError(f"{key}.{name} differs after the load")
            count += 1
        oa, ob = a.optimizers[key].state_dict(), b.optimizers[key].state_dict()
        if oa["param_groups"] != ob["param_groups"] or \
                oa["state"].keys() != ob["state"].keys():
            raise AssertionError(f"{key}: the loaded optimizer differs")
        for index, entry in oa["state"].items():
            for name, value in entry.items():
                if not torch.equal(value, ob["state"][index][name]):
                    raise AssertionError(f"{key}: moment {index} {name} "
                                         f"differs after the load")
                count += 1
    for key in a.disc_ema:
        if not torch.equal(a.disc_ema[key], b.disc_ema[key]):
            raise AssertionError(f"disc_ema {key} differs after the load")
    if a.step != b.step:
        raise AssertionError(f"step {a.step} vs {b.step} after the load")
    return count + len(a.disc_ema)


def _profiled_names(step, state, batch, gen, card: str) -> tuple:
    """One profiled train step: the device table, and which of
    RUNTIME_KERNELS it names.  Retaken (up to twice) where the profiler
    lost the records of a kernel."""
    for attempt in range(3):
        table = profile_step(step, state, batch, gen, card)
        seen = sorted({k.split("<")[0] for k in table["port_kernels"]})
        missing = [n for n in RUNTIME_KERNELS if n not in seen]
        if not missing:
            return table, seen, attempt
        print(f"profiled step {attempt + 1}: no record of {missing}")
    raise AssertionError(f"the profiled train step never names {missing}")


def batch_shape_checks(shapes, card: str) -> list:
    """The STFT and spec-conv kernels held against their plain versions at
    the shapes that runtime batches give them: for each (B, samples) of
    audio, the STFT at every STFT_SHAPES setting on [B, samples] and the
    spec-conv forward, dgrad and wgrad at the MRD's 12 layer shapes of that
    audio (``mrd_layers``), on random inputs.  Raises past KERNEL_TOL or
    the spec-conv tolerances of phase 2, or where a wrapper did not launch
    its kernel."""
    rows = []
    for b, samples in shapes:
        gen = torch.Generator(device="cuda").manual_seed(b * samples)
        x = torch.randn(b, samples, generator=gen, device="cuda")
        stft = max(stft_error(x, *s)[2] for s in STFT_SHAPES)
        del x
        conv = {}
        layers = mrd_layers(b, samples)
        for seed, (_, shape, kt, stride) in enumerate(layers):
            for name, (kernel, plain, _) in conv_calls(
                    shape, kt, stride, seed).items():
                err, scale = conv_error(name, shape, kernel, plain)
                conv[name] = max(conv.get(name, 0.0), err / scale)
        rows.append({"batch": b, "samples": samples, "stft_max_abs_err": stft,
                     "spec_conv_max_rel_err": conv,
                     "widths": [shape[2] for _, shape, _, _ in layers]})
        print(f"runtime batch shape {b} x {samples} samples: stft at "
              f"{len(STFT_SHAPES)} settings max err {stft:.2e}; spec-conv "
              f"at the MRD's {len(layers)} layers (widths "
              f"{rows[-1]['widths']}), max err / max |plain| "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in conv.items()})}"
              f" [{card}]")
    return rows


def runtime_path(mc, device, card: str, kernels,
                 warm_step_ms: float) -> dict:
    """The training runtime at full width: a synthetic dataset written to
    disk, batches from ``BatchManager.epoch_iterator`` into
    RUNTIME_STEPS acoustic steps on the card (each step's wall ms and its
    data wait: the ms blocked on the iterator plus the copy to the card),
    one of them profiled; a checkpoint after RUNTIME_SAVE_AT steps, loaded
    into a state drawn from another seed and held equal tensor by tensor,
    the next step resumed from it with ``skip_batches`` and its metrics
    held against the uninterrupted run's; then the inference artifact
    packaged from the checkpoint, loaded on the card, and one synthesis
    of 80 phonemes from it.  The launch counts are set to 0 before the
    first step and read after the synthesis; then the kernels are held
    against their plain versions at every batch shape the steps took.
    ``warm_step_ms`` (phase 5's median step at b8 x f460) is what the
    producer's time for one full batch is set against."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from stylish_tts_tpu_torch.config import Config, dump_json
    from stylish_tts_tpu_torch.data.batch_manager import BatchManager
    from stylish_tts_tpu_torch.data.collate import collate
    from stylish_tts_tpu_torch.data.dataset import (FilePathDataset,
                                                    get_data_path_list,
                                                    get_frame_count)
    from stylish_tts_tpu_torch.export.infer import Synthesizer
    from stylish_tts_tpu_torch.export.package import (
        load_inference_models, package_inference_artifact)
    from stylish_tts_tpu_torch.text import TextCleaner
    from stylish_tts_tpu_torch.train.checkpoint import (
        Manifest, NormalizationStats, checkpoint_name, load_checkpoint,
        save_checkpoint)
    from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)
    from stylish_tts_tpu_torch.utils.synthetic import make_synthetic_dataset

    out: dict = {"card": card}
    cfg = Config()
    # the stage's models, the MRD and the other two inference models: a
    # state that packages into a whole artifact
    keys = STAGES["acoustic"].train_models + [
        "mrd", "duration_predictor", "pe_text_style_encoder"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        root = Path(tmp)
        # 1. the dataset on disk
        t0 = time.perf_counter()
        make_synthetic_dataset(root / "data", n_segments=RUNTIME_SEGMENTS,
                               seconds=RUNTIME_SECONDS)
        written = time.perf_counter() - t0
        data = root / "data"
        dataset = FilePathDataset(
            data_list=get_data_path_list(data / "train-list.txt"),
            root_path=data / "wav24", text_cleaner=TextCleaner(mc.symbol),
            model_config=mc, pitch_path=str(data / "pitch.safetensors"),
            alignment_path=str(data / "alignment.safetensors"))
        manager = BatchManager(dataset, root / "out", "acoustic",
                               probe_batch_max=8)
        bins = {b: len(i) for b, i in sorted(manager.time_bins.items())}
        out["dataset"] = {"segments": len(dataset), "write_s": written,
                          "bins": bins, "batch_sizes": manager.batch_sizes,
                          "steps_per_epoch": manager.steps_per_epoch()}
        print(f"runtime dataset: {len(dataset)} train segments written in "
              f"{written:.2f} s; segments per bin {bins}; batch sizes "
              f"{manager.batch_sizes}; {manager.steps_per_epoch()} batches "
              f"an epoch [{card}]")

        # the producer's work for one full batch, outside the iterator: the
        # bin nearest TRAIN_FRAMES at its planned size, decoded on a thread
        # pool as wide as the iterator's and collated; the first pass reads
        # the files cold
        near = min(manager.time_bins,
                   key=lambda b: abs(get_frame_count(b) - TRAIN_FRAMES))
        idxs = manager.time_bins[near][:manager.get_batch_size(near)]
        producer_ms = []
        with ThreadPoolExecutor(manager.num_workers) as pool:
            for r in range(4):
                t0 = time.perf_counter()
                items = list(pool.map(dataset.load_item, idxs))
                collate(items, stage="acoustic",
                        rng=np.random.default_rng(r), jitter=True)
                producer_ms.append((time.perf_counter() - t0) * 1e3)
        out["producer"] = {"bin": near, "frames": get_frame_count(near),
                           "batch": len(idxs), "ms": producer_ms,
                           "warm_step_ms": warm_step_ms}
        print(f"runtime producer: decode and collate of one batch of "
              f"{len(idxs)} at bin {near} ({get_frame_count(near)} frames) "
              f"{', '.join(f'{t:.1f}' for t in producer_ms)} ms (the first "
              f"cold), against the warm b{TRAIN_BATCH} x f{TRAIN_FRAMES} step "
              f"of phase 5, {warm_step_ms:.1f} ms [{card}]")

        # 2. acoustic steps fed by the epoch iterator
        def new_state(seed):
            state = build_train_state(
                mc, keys, device=device,
                generator=torch.Generator().manual_seed(seed))
            speech_levels(state.models)
            return state

        state = new_state(30)
        slm = init_slm(mc, torch.Generator().manual_seed(31)).to(device)
        ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                           mel_std=4.0, step_limit=10_000, slm=slm)
        step = make_train_step("acoustic", ctx, 1e-4)
        gen = torch.Generator(device=device).manual_seed(32)
        for k in kernels:
            k.launches = 0

        def fed_step(it, state, gen, profiled=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            numpy_batch = next(it)
            t1 = time.perf_counter()
            batch = on_device(numpy_batch, device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if profiled:
                table, seen, retakes = _profiled_names(step, state, batch,
                                                       gen, card)
                metrics = None
            else:
                _, metrics = step(state, batch, gen)
                torch.cuda.synchronize()
            t3 = time.perf_counter()
            row = {"bin": int(numpy_batch["bin"]),
                   "shape": list(numpy_batch["alignment"].shape),
                   "audio": list(numpy_batch["audio_gt"].shape),
                   "wall_ms": (t3 - t0) * 1e3, "wait_ms": (t2 - t0) * 1e3,
                   "iterator_ms": (t1 - t0) * 1e3,
                   "copy_ms": (t2 - t1) * 1e3, "step_ms": (t3 - t2) * 1e3}
            if profiled:
                # the step's wall inside the profiler; the profiler's own
                # start, stop and table are left out
                row.update(profiled=True, kernels_seen=seen,
                           profile_retakes=retakes,
                           step_ms=table["wall_ms"],
                           wall_ms=row["wait_ms"] + table["wall_ms"],
                           kernels_ms=table["device_ms"])
            else:
                row["metrics"] = {k: v.item() for k, v in metrics.items()}
            return row

        it = manager.epoch_iterator(stage="acoustic", epoch=1)
        rows = []
        for i in range(RUNTIME_STEPS):
            if i == RUNTIME_SAVE_AT:
                # 3. checkpoint, then load into a state from another seed
                manifest = Manifest(current_epoch=1, current_step=i,
                                    steps_per_epoch=manager.steps_per_epoch(),
                                    current_total_step=i, stage="acoustic")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt = save_checkpoint(
                    root / "ckpt", checkpoint_name(1, i), state, manifest,
                    NormalizationStats(), dump_json(cfg), dump_json(mc),
                    generator=gen)
                save_s = time.perf_counter() - t0
                resumed, gen_b = new_state(33), torch.Generator(
                    device=device).manual_seed(34)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, loaded_manifest, _, _ = load_checkpoint(ckpt, resumed,
                                                           gen_b)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                n_equal = _states_equal(state, resumed)
                if not torch.equal(gen.get_state(), gen_b.get_state()):
                    raise AssertionError("the generator state differs after "
                                         "the load")
                nbytes = sum(p.stat().st_size for p in ckpt.rglob("*")
                             if p.is_file())
                out["checkpoint"] = {"bytes": nbytes, "save_s": save_s,
                                     "load_s": load_s,
                                     "tensors_equal": n_equal}
                print(f"checkpoint after step {i}: {nbytes} bytes, save "
                      f"{save_s:.2f} s, load {load_s:.2f} s; {n_equal} "
                      f"tensors and the generator state equal after the "
                      f"load [{card}]")
            rows.append(fed_step(it, state, gen,
                                 profiled=i == RUNTIME_STEPS - 1))
            r = rows[-1]
            busy = (f", kernels {r['kernels_ms']:.1f} ms, profiled"
                    if r.get("profiled") else "")
            print(f"runtime step {i + 1} (bin {r['bin']}, alignment "
                  f"{r['shape']}): wall {r['wall_ms']:.1f} ms, data wait "
                  f"{r['wait_ms']:.1f} ms (iterator {r['iterator_ms']:.1f}, "
                  f"copy {r['copy_ms']:.1f}), step {r['step_ms']:.1f} ms"
                  f"{busy} [{card}]")
        it.close()
        print(f"profiled step: the port's kernels seen "
              f"{rows[-1]['kernels_seen']} [{card}]")

        # the resumed step from the checkpoint, against the uninterrupted
        resumed_it = manager.epoch_iterator(
            stage="acoustic", epoch=1,
            skip_batches=loaded_manifest.current_step)
        row = fed_step(resumed_it, resumed, gen_b)
        resumed_it.close()
        want = rows[RUNTIME_SAVE_AT]
        if (row["bin"], row["shape"]) != (want["bin"], want["shape"]):
            raise AssertionError("the resumed iterator gave another batch")
        # the same weights, batch, generator state and card: every metric
        # is held equal, not within a tolerance
        gap = {}
        for key in STEP_TOL:
            a, b = want["metrics"][key], row["metrics"][key]
            gap[key] = abs(a - b) / max(abs(a), 1e-30)
            if a != b:
                raise AssertionError(f"resumed step {key}: {b} vs the "
                                     f"uninterrupted {a}")
        print(f"resumed step {RUNTIME_SAVE_AT + 1} vs the uninterrupted "
              f"run: relative gaps {json.dumps(gap)}; data wait "
              f"{row['wait_ms']:.1f} ms [{card}]")
        out.update(steps=rows, resumed_step=row, resumed_gap=gap)
        del state, resumed, step, ctx, slm
        torch.cuda.empty_cache()

        # 4. the artifact from the checkpoint, and speech from it
        t0 = time.perf_counter()
        artifact = package_inference_artifact(ckpt, root / "artifact")
        package_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        amc, models = load_inference_models(artifact, device)
        torch.cuda.synchronize()
        artifact_load_s = time.perf_counter() - t0
        synth = Synthesizer(amc, models, device=device, sample_seed=0)
        text = phoneme_strings(amc.symbol, [80], seed=1)[0]
        t0 = time.perf_counter()
        audio = synth.synthesize(text, fixed_duration=8)
        synth_s = time.perf_counter() - t0
        check_audio(audio, 80 + 2, 8, amc.hop_length,
                    "synthesize from the packaged artifact")
        launches = {k.name: k.launches for k in kernels}
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"{name} never launched on the "
                                     f"runtime phase")
        out.update(package_s=package_s, artifact_load_s=artifact_load_s,
                   synthesis={"audio_s": audio.shape[0] / amc.sample_rate,
                              "wall_s": synth_s,
                              "max_abs": float(np.abs(audio).max())},
                   launches=launches)
        print(f"artifact: packaged in {package_s:.2f} s, loaded on the card "
              f"in {artifact_load_s:.2f} s; synthesize(80 phonemes) "
              f"{audio.shape[0] / amc.sample_rate:.2f} s of audio in "
              f"{synth_s * 1e3:.1f} ms (first request), max |audio| "
              f"{np.abs(audio).max():.3f} [{card}]")
        print(f"runtime phase launches: {launches}")
    waits = [r["wait_ms"] for r in rows[1:]]
    steps_ms = [r["step_ms"] for r in rows[1:-1]]
    print(f"runtime: data wait of steps 2-{RUNTIME_STEPS} "
          f"{', '.join(f'{w:.1f}' for w in waits)} ms against unprofiled "
          f"steps of {', '.join(f'{s:.1f}' for s in steps_ms)} ms; "
          f"checkpoint {out['checkpoint']['bytes']} bytes, save "
          f"{out['checkpoint']['save_s']:.2f} s, load "
          f"{out['checkpoint']['load_s']:.2f} s, package {package_s:.2f} s "
          f"[{card}]")
    del synth, models
    torch.cuda.empty_cache()
    out["batch_shape_checks"] = batch_shape_checks(
        sorted({tuple(r["audio"]) for r in rows}), card)
    return out


# --------------------------------------------------------------------------- #
# the training chain: CLI train through the four stages


def _snapshots_equal(a, b, what: str) -> int:
    """Raise where two ``snapshot_state`` results differ in any tensor,
    moment or count; returns how many tensors were compared."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: keys differ")
        return sum(_snapshots_equal(a[k], b[k], f"{what}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths differ")
        return sum(_snapshots_equal(x, y, f"{what}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    if torch.is_tensor(a):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
        return 1
    if a != b:
        raise AssertionError(f"{what}: {a} vs {b}")
    return 0


def _stage_hook(kernels, record: dict):
    """The train loop's ``on_stage``: at a stage's start the launch counts
    go to 0 and the state is snapshotted to the host; after the memory plan
    the state must equal that snapshot; at the end the counts are read and
    each model's parameters checked for movement against the snapshot."""
    from stylish_tts_tpu_torch.train.state import snapshot_state

    def hook(event: str, stage: str, state) -> None:
        torch.cuda.synchronize()
        record["events"].append([event, stage])
        if event == "start":
            for k in kernels:
                k.launches = 0
            record["start"] = snapshot_state(state)
            return
        if event == "planned":
            n = _snapshots_equal(snapshot_state(state), record["start"],
                                 f"{stage} state after the memory probe")
            record["stages"][stage] = {"probe_equal_tensors": n}
            return
        start = record.pop("start")["models"]
        moved = {}
        for key, module in state.models.items():
            params = {n for n, _ in module.named_parameters()}
            now = module.state_dict()
            moved[key] = [n for n in now if not torch.equal(
                now[n].cpu(), start[key][n])]
            moved[key] = {"params": sum(n in params for n in moved[key]),
                          "buffers": sum(n not in params
                                         for n in moved[key])}
        record["stages"][stage].update(
            launches={k.name: k.launches for k in kernels}, moved=moved)

    return hook


def chain_path(device, card: str, kernels) -> dict:
    """CLI ``train`` through acoustic -> textual -> style -> duration at
    full width on a synthetic dataset on disk, with the measured memory
    plan; then ``convert`` and ``speak`` through the CLI; see the module
    docstring, phase 7."""
    import functools
    import tempfile
    import wave

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, ModelConfig, dump_json
    from stylish_tts_tpu_torch.data.dataset import (FilePathDataset,
                                                    get_data_path_list,
                                                    get_frame_count)
    from stylish_tts_tpu_torch.export.infer import Synthesizer
    from stylish_tts_tpu_torch.export.package import load_inference_models
    from stylish_tts_tpu_torch.scripts.spec_conv_times import \
        LAUNCHES_PER_LAYER
    from stylish_tts_tpu_torch.text import TextCleaner
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.train.stages import STAGES
    from stylish_tts_tpu_torch.utils.synthetic import make_synthetic_dataset

    t_phase = time.perf_counter()
    mc = ModelConfig()
    budget = int(CHAIN_BUDGET_SHARE
                 * torch.cuda.get_device_properties(0).total_memory / 2**20)
    print(f"chain: memory_budget_mib {budget} ({CHAIN_BUDGET_SHARE:.0%} of "
          f"the card's memory) [{card}]")
    record: dict = {"events": [], "stages": {}, "card": card,
                    "memory_budget_mib": budget}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp:
        root = Path(tmp)
        data, out = root / "data", root / "out"
        make_synthetic_dataset(data, n_segments=CHAIN_SEGMENTS,
                               seconds=CHAIN_SECONDS, spread=CHAIN_SPREAD,
                               n_val=CHAIN_VAL)
        dataset = FilePathDataset(
            data_list=get_data_path_list(data / "train-list.txt"),
            root_path=data / "wav24", text_cleaner=TextCleaner(mc.symbol),
            model_config=mc)
        bins, _ = dataset.time_bins()
        per_epoch_s = sum(len(i) * get_frame_count(b) * mc.hop_length
                          for b, i in bins.items()) / mc.sample_rate
        record["bins"] = {int(b): len(i) for b, i in sorted(bins.items())}
        cfg = Config()
        cfg.dataset.path = str(data)
        for stage in CHAIN:
            plan = getattr(cfg.training_plan, stage)
            plan.epochs, plan.probe_batch_max = 1, 8
        cfg.training.log_interval = 1
        cfg.training.val_interval = cfg.training.save_interval = \
            CHAIN_INTERVAL
        cfg.training.aot_memory_plan = True
        cfg.training.memory_budget_mib = budget
        (root / "config.json").write_text(dump_json(cfg))
        print(f"chain dataset: {len(dataset)} train segments per bin "
              f"{record['bins']}, {per_epoch_s:.1f} s of padded audio an "
              f"epoch; every stage 1 epoch [{card}]")

        original = loop.train_model
        loop.train_model = functools.partial(
            original, on_stage=_stage_hook(kernels, record))
        t0 = time.perf_counter()
        try:
            cli.main(["train", "--config", str(root / "config.json"),
                      "--out", str(out)])
        finally:
            loop.train_model = original
        record["train_s"] = time.perf_counter() - t0

        # the chain's order, its checkpoints and their manifests
        want = [[e, s] for s in CHAIN for e in ("start", "planned", "end")]
        if record["events"] != want:
            raise AssertionError(f"stage events {record['events']}")
        total_steps, audio_s = 0, 0.0
        for stage in CHAIN:
            stats = json.loads((out / stage / "train_stats.json").read_text())
            meta = json.loads((out / stage / "checkpoint_final" / "meta.json")
                              .read_text())
            man = meta["manifest"]
            total_steps += stats["steps"]
            audio_s += per_epoch_s
            if (man["stage"], man["current_step"], man["current_epoch"],
                    man["current_total_step"], man["steps_per_epoch"]) != (
                    stage, stats["steps"], 1, total_steps, stats["steps"]):
                raise AssertionError(f"{stage}: manifest {man}, "
                                     f"{stats['steps']} steps")
            if abs(man["total_trained_audio_seconds"] - audio_s) > \
                    1e-9 * audio_s:
                raise AssertionError(f"{stage}: audio seconds "
                                     f"{man['total_trained_audio_seconds']}"
                                     f" vs {audio_s}")
            _check_chain_stage(stage, stats, record["stages"][stage],
                               STAGES[stage], out, LAUNCHES_PER_LAYER,
                               card)
            record["stages"][stage]["stats"] = stats
            record["stages"][stage]["manifest"] = man
        if not np.isfinite(man["best_loss"]):
            raise AssertionError(f"best_loss {man['best_loss']}")
        print(f"chain: CLI train {record['train_s']:.1f} s for "
              f"{total_steps} steps, {audio_s:.1f} s of audio [{card}]")

        # convert and speak through the CLI on the chain's last checkpoint
        artifact, wav = root / "artifact", root / "speech.wav"
        text = phoneme_strings(mc.symbol, [80], seed=5)[0]
        t0 = time.perf_counter()
        cli.main(["convert", "--checkpoint",
                  str(out / "duration" / "checkpoint_final"),
                  "--out", str(artifact)])
        cli.main(["speak", "--artifact", str(artifact), "--phonemes", text,
                  "--out", str(wav)])
        with wave.open(str(wav), "rb") as f:
            frames = f.getnframes()
            pcm = np.frombuffer(f.readframes(frames), "<i2")
        if frames == 0 or frames % mc.hop_length or not np.abs(pcm).max():
            raise AssertionError(f"speak wrote {frames} samples, max "
                                 f"{np.abs(pcm).max() if frames else 0}")
        amc, models = load_inference_models(artifact, device)
        synth = Synthesizer(amc, models, device=device, sample_seed=0)
        audio = synth.synthesize(text, fixed_duration=8)
        check_audio(audio, 80 + 2, 8, amc.hop_length,
                    "synthesize from the chain's artifact")
        record["artifact"] = {"speak_samples": frames,
                              "synth_audio_s": audio.shape[0]
                              / amc.sample_rate,
                              "max_abs": float(np.abs(audio).max()),
                              "convert_speak_s": time.perf_counter() - t0}
        print(f"chain artifact: CLI speak wrote {frames / mc.sample_rate:.2f}"
              f" s of predicted durations; 80 phonemes at 8 frames each "
              f"{audio.shape[0] / amc.sample_rate:.2f} s, max |audio| "
              f"{np.abs(audio).max():.3f} [{card}]")
        del synth, models
    torch.cuda.empty_cache()
    shapes = sorted({(rows, samples) for _, rows, _, samples in
                     record["stages"]["textual"]["stats"]["batches"]})
    record["batch_shape_checks"] = batch_shape_checks(shapes, card)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"chain phase: {record['seconds']:.1f} s [{card}]")
    return record


def _check_chain_stage(stage, stats, seen, stage_type, out,
                       per_layer, card) -> None:
    """One stage of the chain against what it must have done; prints its
    numbers."""
    from stylish_tts_tpu_torch.scripts.spec_conv_times import mrd_layers

    trained = stage_type.train_models + stage_type.discriminators
    for key, moved in seen["moved"].items():
        if key in trained and not moved["params"]:
            raise AssertionError(f"{stage}: {key} did not move")
        if key not in trained and (moved["params"] or moved["buffers"]):
            raise AssertionError(f"{stage}: {key} changed: {moved}")
    probe = stats["probe"]
    if not probe or not probe["measured"]:
        raise AssertionError(f"{stage}: the memory probe did not run")
    sizes = json.loads((out / stage / f"{stage}_batch_sizes.json")
                       .read_text())
    if sizes != probe["batch_sizes"] or min(sizes.values()) < 1:
        raise AssertionError(f"{stage}: batch sizes {sizes}")
    values = [e["loss"] for e in stats["logs"]] + [
        v for e in stats["logs"] for v in e["metrics"].values()] + [
        v["loss"] for v in stats["validations"]] + [
        m for v in stats["validations"] for m in v["metrics"].values()]
    if not stats["validations"]:
        raise AssertionError(f"{stage}: no validation")
    if not all(np.isfinite(values)):
        raise AssertionError(f"{stage}: non-finite metrics")
    launches = seen["launches"]
    if launches["stft_forward"] == 0:
        raise AssertionError(f"{stage}: the STFT never launched")
    measured = [m for m in probe["measured"] if m[2] is not None]
    mrd_steps = len(measured) + stats["steps"]
    clean = stats["guard"]["oom"] == 0 and len(measured) == len(
        probe["measured"])
    for name, n in per_layer.items():
        got = launches[f"spec_conv_{name}"]
        want = (n * len(mrd_layers()) * mrd_steps
                if "mrd" in stage_type.discriminators else 0)
        # a step that ran out of memory launched some of its kernels
        ok = got == want if clean or not want else got >= want
        if not ok:
            raise AssertionError(f"{stage}: spec_conv_{name} launched {got} "
                                 f"times, the MRD's layers give {want}")
    # log_interval 1: one log window a step; a step is warm where its
    # (rows, tokens, samples) shape ran before in the stage
    shapes, first, warm = set(), [], []
    for entry, (_, *shape) in zip(stats["logs"], stats["batches"]):
        (warm if tuple(shape) in shapes else first).append(
            round(entry["seconds"] * 1e3))
        shapes.add(tuple(shape))
    fit = (f"fixed {probe['fixed'] / 2**20:.0f} MiB, "
           f"{probe['per_sample_frame'] / 2**20:.3f} MiB per sample-frame"
           if probe["kept"] is None else f"plan kept: {probe['kept']}")
    print(f"chain {stage}: probe {probe['seconds']:.1f} s over "
          f"{len(probe['measured'])} measured steps, {fit}, "
          f"batch sizes {sizes} (state equal after: "
          f"{seen['probe_equal_tensors']} tensors); {stats['steps']} steps "
          f"{stats['batches']}, wall ms first visit {first}, warm "
          f"{warm or 'none'}; validation "
          f"{[round(v['seconds'], 2) for v in stats['validations']]} s, "
          f"saves {[round(v['seconds'], 2) for v in stats['saves']]} s; "
          f"guard snapshots {stats['guard']['snapshots']} in "
          f"{stats['guard']['snapshot_s']:.2f} s, OOM "
          f"{stats['guard']['oom']}; launches {launches} [{card}]")


# --------------------------------------------------------------------------- #
# the main path


def seeded_models(mc, seed: int):
    """The five inference models with every parameter drawn from a seeded
    torch.Generator, at the levels of a trained model where random ones
    would break synthesis: F0 of speech (random weights give a few Hz:
    unvoiced throughout), small prior/flow heads (exp(logstd) would
    overflow and compound over the 8 flows), and a log-amplitude that
    keeps the iSTFT output out of the final tanh's saturation."""
    from stylish_tts_tpu_torch.models import build_models

    gen = torch.Generator().manual_seed(seed)
    models = build_models(mc)
    with torch.no_grad():
        for model in models.values():
            for name, p in model.named_parameters():
                normal = torch.randn(p.shape, generator=gen)
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "gamma" or (leaf == "weight" and p.dim() == 1):
                    p.copy_(1.0 + 0.1 * normal)  # norm scales
                elif leaf == "weight":
                    p.copy_(normal / p[0].numel() ** 0.5)
                else:
                    p.copy_(0.1 * normal)  # biases, betas
    return speech_levels(models)


@torch.no_grad()
def speech_levels(models):
    """Set the four heads of ``models`` that synthesis needs at a trained
    model's levels, in place: F0 of speech, small prior and flow heads, a
    log-amplitude below the final tanh's saturation."""
    pe = models["pitch_energy_predictor"]
    pe.f0_proj.weight.mul_(50.0)
    pe.f0_proj.bias.add_(180.0)  # Hz
    sp = models["speech_predictor"]
    heads = [sp.prior_encoder] + [getattr(sp.flow, f"flow_{i}")
                                  for i in range(sp.flow.n_flows)]
    for head in heads:
        head.proj_mean.weight.mul_(0.1)
        head.proj_logstd.weight.mul_(0.1)
    sp.generator.amp_output_conv.Conv_0.weight.mul_(0.1)
    return models


def phoneme_strings(symbols, counts, seed: int):
    from stylish_tts_tpu_torch.text import TextCleaner

    inventory = list(symbols.letters_ipa + symbols.letters)
    rng = np.random.default_rng(seed)
    texts = ["".join(rng.choice(inventory, n)) for n in counts]
    cleaner = TextCleaner(symbols)
    for text, n in zip(texts, counts):
        if len(cleaner(text)) != n:
            raise AssertionError("a drawn symbol is not in the inventory")
    return texts


def check_audio(audio: np.ndarray, n_tokens: int, per_token: int, hop: int,
                what: str) -> None:
    want = n_tokens * per_token * hop
    if audio.shape != (want,):
        raise AssertionError(f"{what}: {audio.shape} samples, want {want}")
    if not np.all(np.isfinite(audio)):
        raise AssertionError(f"{what}: non-finite audio")
    if not np.abs(audio).max() > 0:
        raise AssertionError(f"{what}: silent audio")


def cpu_vs_card(mc, models_cpu, synth, text: str) -> float:
    """The full-width models on the CPU (plain ops) and on the card, on one
    short input: style, duration logits, pitch and energy agree."""
    from stylish_tts_tpu_torch.export.infer import Synthesizer

    ref = Synthesizer(mc, models_cpu, device="cpu")
    worst = 0.0
    outs = []
    for s in (ref, synth):
        tokens, lengths, (n,) = s.encode_batch([text])
        style = s.style_graph(tokens, lengths)
        logits = s.duration_logits(tokens, lengths)
        durs = torch.full_like(tokens, 8)
        align = s.duration_processor.batched_duration_to_alignment(
            durs, 8 * n + 4)
        with torch.no_grad():
            pe_enc, _, _ = s.models["pe_text_encoder"](tokens, lengths)
            pitch, energy = s.models["pitch_energy_predictor"](
                pe_enc, lengths, align, style)
        outs.append([v.float().cpu() for v in (style, logits, pitch, energy)])
    for name, a, b in zip(("style", "duration logits", "pitch", "energy"),
                          *outs):
        err = (a - b).abs().max().item()
        # f32 on both (TF32 off), summed in another order
        bound = 1e-3 * a.abs().max().item() + 1e-5
        if not err <= bound:
            raise AssertionError(f"cpu vs card {name}: {err:.3e} > {bound:.3e}")
        worst = max(worst, err / max(a.abs().max().item(), 1e-30))
    return worst


def profile_batch(synth, batch, card: str) -> dict:
    """Device time by kernel over one ``synthesize_batch`` (torch.profiler)
    and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize_batch(batch, fixed_duration=8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_table(prof, wall_ms, "synthesize_batch(8)", card)


def _device_table(prof, wall_ms: float, what: str, card: str) -> dict:
    rows = []
    for evt in prof.key_averages():  # kernels only: operators would count
        if evt.device_type != torch.autograd.DeviceType.CUDA:  # them twice
            continue
        rows.append((evt.self_device_time_total / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"profile {what}: wall {wall_ms:.1f} ms, kernels "
          f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%) [{card}]")
    for dev, count, key in rows[:15]:
        print(f"  {dev:8.3f} ms {100 * dev / device_ms:5.1f}% x{count:<5d} "
              f"{key[:90]}")
    # the port's own kernels, wherever they rank
    port = {}
    for dev, count, key in rows:
        for sym in PORT_KERNEL_SYMBOLS:
            if sym not in key:
                continue
            name = key[key.index(sym):].split("(")[0]  # with its template
            ms, n = port.get(name, (0.0, 0))
            port[name] = (ms + dev, n + count)
    print("  the port's kernels: " + ", ".join(
        f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in port.items()))
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "top": [{"ms": d, "count": c, "name": k} for d, c, k in rows[:40]],
            "port_kernels": {k: {"ms": ms, "count": n}
                             for k, (ms, n) in port.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import copy

    from stylish_tts_tpu_torch.config import ModelConfig
    from stylish_tts_tpu_torch.device import resolve_device
    from stylish_tts_tpu_torch.export.infer import Synthesizer, frame_bucket
    from stylish_tts_tpu_torch.ops import patch_probe as pp
    from stylish_tts_tpu_torch.ops import spec_conv as sc
    from stylish_tts_tpu_torch.ops.build import CSRC_DIR, build, build_log
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    kernels = [stft_forward, *sc.KERNELS]
    record = {}

    # 1. device and build
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    stems = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    build(stems)
    print(f"build: {', '.join(stems)} {time.perf_counter() - t0:.1f} s")
    for stem in stems:
        for line in build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # 2. kernels vs plain: the STFT at its five shapes, B=4, 10 s at 24 kHz
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 240000)).astype(np.float32)
                         ).to(device)
    record["stft_shapes"] = []
    for n_fft, hop, win in STFT_SHAPES:
        r = stft_numbers(x, n_fft, hop, win, flush)
        record["stft_shapes"].append(r)
        print(f"stft n_fft={n_fft} hop={hop} win={win} x={r['shape']}: "
              f"{stft_line(r)} [{card}]")
    del x
    # ... and the spec-conv kernels at the MRD's layer shapes
    record["spec_conv"] = {}
    for seed, (label, shape, kt, stride) in enumerate(CONV_SHAPES):
        r = spec_conv_numbers(shape, kt, stride, flush, seed)
        record["spec_conv"][label] = r
        for name, n in r.items():
            print(f"spec_conv_{name} {label} {shape} kt={kt} s={stride}: "
                  f"kernel {n['ms']:.3f} ms [{n['device_ms']:.4f}] "
                  f"({n['tflops_per_s']:.1f} TFLOP/s by span)"
                  f", plain {n['plain_ms']:.3f} ms, cuDNN bf16 "
                  f"{n['library_ms']:.3f} ms [{n['library_device_ms']:.4f}], "
                  f"bound {n['bound_ms']:.3f} ms "
                  f"({n['bound_by']}), max err {n['max_abs_err']:.2e} of "
                  f"{n['max_abs_plain']:.2e} [{card}]")
    torch.cuda.empty_cache()
    # ... and the three kernels at every spec-conv layer shape of the MRD
    per_step = LAUNCHES_PER_LAYER
    for name in per_step:
        record[f"spec_conv_{name}_layers"] = {}
    totals = {name: [0.0, 0.0] for name in per_step}
    for seed, (label, shape, kt, stride) in enumerate(mrd_layers()):
        times = layer_times(shape, kt, stride, 100 + seed, tuple(per_step))
        b, h, w, c = shape
        w_out = sc.out_width(w, stride)
        flops = 2.0 * b * h * w_out * 3 * kt * c * c
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        nbytes = {"forward": 2.0 * (b * h * w * c + 3 * kt * c * c + c
                                    + b * h * w_out * c),
                  "dgrad": 2.0 * (b * h * w_out * c + 3 * kt * c * c
                                  + b * h * w * c),
                  "wgrad": 2.0 * (b * h * w * c + b * h * w_out * c)
                  + 4.0 * 3 * kt * c * c}
        for name, r in times.items():
            t_bytes = nbytes[name] / PEAK_BYTES * 1e3
            kernel = getattr(sc, f"spec_conv_{name}")
            r.update(shape=list(shape), kt=kt, stride=stride,
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     tflops_per_s=flops / r["device_ms"] * 1e-9,
                     plan=kernel.plan(b, h, w, kt, stride))
            record[f"spec_conv_{name}_layers"][label] = r
            totals[name][0] += per_step[name] * r["device_ms"]
            totals[name][1] += per_step[name] * r["library_device_ms"]
            split = "".join(f", {f} {ms:.4f}" for f, ms in
                            r.get("function_device_ms", {}).items())
            print(f"spec_conv_{name} {label} {shape} kt={kt} s={stride}: "
                  f"device {r['device_ms']:.4f} ms{split} "
                  f"({r['tflops_per_s']:.1f} TFLOP/s), cuDNN bf16 "
                  f"{r['library_device_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{per_step[name]} per step, plan {r['plan']}, max err "
                  f"{r['max_abs_err']:.2e} of {r['max_abs_plain']:.2e} "
                  f"[{card}]")
    for name, n in per_step.items():
        record[f"spec_conv_{name}_step_ms"] = {"kernel": totals[name][0],
                                               "cudnn": totals[name][1]}
        print(f"spec_conv_{name} over the train step's "
              f"{n * len(mrd_layers())} launches (device time, L2 warm): "
              f"kernel {totals[name][0]:.3f} ms, cuDNN bf16 "
              f"{totals[name][1]:.3f} ms [{card}]")
    torch.cuda.empty_cache()

    # 3. the patch-staging probes, then their entry point
    record["probes"] = probe_numbers(device)
    print(f"probe kernels: times are means over 100 back-to-back launches "
          f"between one pair of CUDA events, L2 not flushed; [device] is "
          f"the kernels' own time by torch.profiler, without the host's "
          f"launch gaps [{card}]")
    for name, n in record["probes"].items():
        note = (" (over all 128 channels: twice the useful FLOP)"
                if name == "probe_mini_kernel" else "")
        print(f"{name} {n['shapes']}: kernel {n['ms'] * 1e3:.2f} us "
              f"[{n['device_ms'] * 1e3:.2f}], plain "
              f"{n['plain_ms'] * 1e3:.2f} us [{n['plain_device_ms'] * 1e3:.2f}]"
              f", library {n['library_ms'] * 1e3:.2f} us "
              f"[{n['library_device_ms'] * 1e3:.2f}]{note}, bound "
              f"{n['bound_ms'] * 1e3:.3f} us ({n['bound_by']}), max err "
              f"{n['max_abs_err']:.2e} of {n['max_abs_plain']:.2e} [{card}]")
    # ... the copies and the products where bytes and operations set the
    # time, and the mini kernel where its blocks walk many row tiles ...
    record["probes_large"] = probe_times(device, LARGE_T)
    print(f"the copy and product probes at T = {LARGE_T} and the mini kernel "
          f"at R = {MINI_ROWS[LARGE_T]}: device time by torch.profiler beside "
          f"the bound, held against the plain version (copies bit-equal) "
          f"[{card}]")
    for name, n in record["probes_large"].items():
        print(f"{times_line(name, n)} [{card}]")
    torch.cuda.empty_cache()
    # ... and the probe entry point
    record["probe_run"] = probe_run(device, pp.KERNELS, card)

    # 4. synthesis at full width
    mc = ModelConfig()
    models = seeded_models(mc, seed=0)
    models_cpu = copy.deepcopy(models)
    synth = Synthesizer(mc, models, device=device, sample_seed=0)
    single = phoneme_strings(mc.symbol, [80], seed=1)[0]
    counts = [int(n) for n in np.random.default_rng(2).integers(40, 161, 8)]
    batch = phoneme_strings(mc.symbol, counts, seed=3)
    hop = mc.hop_length

    synth.synthesize(single, fixed_duration=8)  # warm-up: cuDNN and caches
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    # the allocator's new segments (cudaMalloc calls) in each request: the
    # first request at a shape grows the cache
    t_single, t_batch, segments = [], [], {"single": [], "batch8": []}

    def allocated():
        return torch.cuda.memory_stats()["segment.all.allocated"]

    for _ in range(3):
        t0, s0 = time.perf_counter(), allocated()
        audio = synth.synthesize(single, fixed_duration=8)
        t_single.append(time.perf_counter() - t0)
        segments["single"].append(allocated() - s0)
    for _ in range(2):
        t0, s0 = time.perf_counter(), allocated()
        audios = synth.synthesize_batch(batch, fixed_duration=8)
        t_batch.append(time.perf_counter() - t0)
        segments["batch8"].append(allocated() - s0)
    synth_launches = {k.name: k.launches for k in kernels}
    if synth_launches["stft_forward"] == 0:
        raise AssertionError("stft_forward never launched on synthesis")
    print(f"synthesis launches: {synth_launches}")

    check_audio(audio, 80 + 2, 8, hop, "synthesize")
    for i, (a, n) in enumerate(zip(audios, counts)):
        check_audio(a, n + 2, 8, hop, f"synthesize_batch[{i}]")
    sec_single = audio.shape[0] / mc.sample_rate
    sec_batch = sum(a.shape[0] for a in audios) / mc.sample_rate
    record["rtf"] = {
        "single": {"phonemes": 80, "audio_s": sec_single, "wall_s": t_single,
                   "rtf": sec_single / float(np.median(t_single))},
        "batch8": {"phonemes": counts, "audio_s": sec_batch,
                   "wall_s": t_batch,
                   "rtf": sec_batch / float(np.median(t_batch))},
        "launches": synth_launches, "new_segments": segments, "card": card,
    }
    for name, sec, walls, new in (
            ("synthesize", sec_single, t_single, segments["single"]),
            ("synthesize_batch(8)", sec_batch, t_batch, segments["batch8"])):
        print(f"{name}: {sec:.2f} s of audio in "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, RTF "
              f"{sec / float(np.median(walls)):.1f}x (median), new allocator "
              f"segments {new} [{card}]")

    # the STFT kernel against its plain version at the shapes this path
    # gave it: the prior of the batch request, [8, frames * 300] at the
    # generator's hop
    frames = max(frame_bucket((n + 2) * 8) for n in counts)
    prior = torch.from_numpy(
        np.random.default_rng(4).standard_normal((8, frames * hop))
        .astype(np.float32) * 0.05).to(device)
    main = stft_numbers(prior, mc.n_fft, hop // 4, mc.win_length, flush)
    record["stft_main_path"] = main
    frames_single = frame_bucket(82 * 8)
    prior1 = prior[:1, : frames_single * hop].contiguous()
    record["stft_main_path_single"] = stft_numbers(
        prior1, mc.n_fft, hop // 4, mc.win_length, flush)
    print(f"stft at the synthesis shapes {main['shape']} and "
          f"{record['stft_main_path_single']['shape']}: {stft_line(main)} "
          f"[{card}]")

    if "--profile" in sys.argv[1:]:
        record["profile"] = profile_batch(synth, batch, card)

    worst = cpu_vs_card(mc, models_cpu, synth, batch[0][:20])
    print(f"full-width models, cpu vs card on 20 phonemes: worst relative "
          f"error {worst:.2e}")
    del synth, models, models_cpu
    torch.cuda.empty_cache()

    # 5. training: the acoustic step at full width
    train, state, step, tbatch, gen = train_path(mc, device, card, kernels)
    record["train"] = train
    for name, n in per_step.items():
        want = n * len(mrd_layers())
        got = train["launches_per_step"][f"spec_conv_{name}"]
        if got != want:
            raise AssertionError(f"spec_conv_{name}: {got} launches a train "
                                 f"step, the MRD's layers give {want}")
    # the STFT at the train step's largest shape: the magphase target and
    # the posterior encoder, [8, 138000] at n_fft 2048, hop 75
    train_stft = stft_numbers(tbatch["audio_gt"], mc.n_fft, hop // 4,
                              mc.win_length, flush)
    record["stft_train_path"] = train_stft
    print(f"stft at the train step's shape {train_stft['shape']}: "
          f"{stft_line(train_stft)} [{card}]")
    if "--profile" in sys.argv[1:]:
        record["profile_train"] = profile_step(step, state, tbatch, gen,
                                               card)
        port = record["profile_train"]["port_kernels"]
        for name, prefixes in (("forward", ("spec_conv_fwd",)),
                               ("dgrad", ("spec_conv_dgrad",)),
                               ("wgrad", ("spec_conv_wgrad",
                                          "sum_partials"))):
            found = [v for k, v in port.items() if k.startswith(prefixes)]
            main_launches = sum(v["count"] for k, v in port.items()
                                if k.startswith(prefixes[0]))
            print(f"profiled train step: spec_conv_{name} "
                  f"{sum(v['ms'] for v in found):.3f} ms over "
                  f"{main_launches} launches; the 12 layer shapes x "
                  f"{per_step[name]} above: "
                  f"{record[f'spec_conv_{name}_step_ms']['kernel']:.3f} ms "
                  f"[{card}]")
    del state, step, tbatch, gen
    torch.cuda.empty_cache()
    record["train_cpu_vs_card"] = cpu_vs_card_step(mc, card)

    # 6. the training runtime: dataset on disk, steps fed by the epoch
    # iterator, checkpoint and resume, the artifact and speech from it
    record["runtime"] = runtime_path(mc, device, card, kernels,
                                     train["median_s"] * 1e3)

    # 7. the training chain through CLI train, then convert and speak
    record["chain"] = chain_path(device, card, kernels)

    # 8. results: each kernel's own numbers and its launches on the path
    # that runs it: per train step, or per probe run
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    numbers = {"stft_forward": train_stft, **record["probes"]}
    for name in ("forward", "dgrad", "wgrad"):
        numbers[f"spec_conv_{name}"] = record["spec_conv"]["res0 conv_1"][name]
    launches = {k: (n, "train step")
                for k, n in train["launches_per_step"].items()}
    launches.update({k: (n, "probe run")
                     for k, n in record["probe_run"]["launches"].items()})
    entries = []
    for k in [*kernels, *pp.KERNELS]:
        n = numbers[k.name]
        count, per = launches[k.name]
        entries.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": count, "per": per,
            "max_abs_err": n["max_abs_err"], "ms": n["ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"], "library_ms": n["library_ms"],
            "device_ms": n["device_ms"],  # torch.profiler
            "library_device_ms": n["library_device_ms"],
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

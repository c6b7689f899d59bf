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
6. one JSON line of every kernel's numbers, with its launches on the path
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


def stft_numbers(x: torch.Tensor, n_fft: int, hop: int, win: int,
                 flush: torch.Tensor) -> dict:
    """Hold the kernel against the plain version on ``x`` and time both,
    torch.stft, and the bound."""
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
            raise AssertionError(f"stft {part} n_fft={n_fft} hop={hop}: "
                                 f"max err {e:.3e} > {KERNEL_TOL} * {scale:.3e}")
        err = max(err, e)

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
        counter = getattr(sc, f"spec_conv_{name}")
        before = counter.launches
        got = kernel()
        if counter.launches != before + 1:
            raise AssertionError(f"spec_conv_{name}: no kernel launch")
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_error(name, shape, got, want)
        del got, want
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
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


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
    # f32 terms: the same f32 model on two devices, sums in another order;
    # the MRD and the SLM run in bf16 on both, through cuDNN and the kernels
    # on one and the CPU's convs on the other
    tol = {"mel": 1e-3, "mag": 1e-3, "phase": 1e-3, "pitch": 1e-3,
           "energy": 1e-3, "slm": 2e-2, "generator": 2e-2,
           "discriminator": 2e-2, "loss": 2e-3}
    rel = {}
    for key, bound in tol.items():
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

    # 6. results: each kernel's own numbers and its launches on the path
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

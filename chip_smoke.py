"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:

1. device and build: the card's name and power limit, CUDA version, and
   the build of every kernel source of the port (``csrc/*.cu``, one
   ``nvcc`` each, started together), with the compiler's register and
   spill report;
2. kernels vs plain: the STFT kernel on random f32 input at its shapes, and
   the MRD's spec-conv forward, dgrad and wgrad kernels at the MRD's real
   layer shapes (b8 x f460), each held against its plain PyTorch version,
   with its time, the plain version's, a library call's (a yardstick the
   port never calls) and its bound;
3. synthesis: ``Synthesizer`` at the default full-width ModelConfig with
   seeded random weights serves one ``synthesize`` of 80 phonemes and one
   ``synthesize_batch`` of 8 utterances; the launch counts are set to 0
   just before and read just after, and the audio is checked (finite, not
   silent, exactly total_frames * hop samples); the STFT kernel is held
   against its plain version at this path's shapes, and the CPU and card
   outputs of the full-width models are compared on a short input;
4. training (this slice's main path): the acoustic-stage train state at
   the full-width ModelConfig and the default Config (bf16 mixed
   precision, 12-layer frozen SLM from a seed) takes one warm-up step and
   3 timed steps on one synthetic batch of 8 x 460 mel frames; the launch
   counts are set to 0 before the timed steps and read after; the metrics
   are finite, every train model and the MRD moved, the discriminator EMA
   changed and every kernel launched; then one f32 step at full width on
   1 x 64 frames runs on the CPU and on the card from the same weights and
   their metrics are compared;
5. one JSON line of every kernel's numbers, then the result line.

``--profile`` adds torch.profiler breakdowns of one batch request and of
one train step: device time by kernel and the device's busy share of the
wall time.

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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

STFT_SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
               (2048, 240, 1200), (2048, 300, 1200)]
KERNEL_TOL = 1e-4  # max|kernel - plain| <= KERNEL_TOL * max|plain|
# the MRD's spec-conv layers at b8 x f460 (138,000 samples): res 0 conv_1
# (the largest), res 1 conv_1 (an odd width: a partial tile), res 2 conv_4;
# (label, [B, H, W, 32], kt, stride)
CONV_SHAPES = [("res0 conv_1", (8, 257, 2761, 32), 9, 2),
               ("res1 conv_1", (8, 513, 1151, 32), 9, 2),
               ("res2 conv_4", (8, 1025, 72, 32), 3, 1)]
# bf16 outputs: one bf16 rounding of f32 sums taken in another order; the
# f32 weight gradient: sums of millions of bf16 products in another order
CONV_TOL = {"forward": 1e-2, "dgrad": 1e-2, "wgrad": 1e-3}
TRAIN_BATCH, TRAIN_FRAMES = 8, 460


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
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward, window_taps

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
    library_ms = time_ms(lambda: torch.stft(
        x, n_fft, hop, n_fft, window, center=True, pad_mode="reflect",
        return_complex=True), flush=flush)

    # the least the card could take for this function, whatever the
    # algorithm: a real FFT of n_fft points per frame, about
    # 2.5 * n_fft * log2(n_fft) FLOP (half a complex radix-2 FFT's
    # 5 N log2 N), plus the window's n_fft products; bytes are the signal
    # and the window read once and (real, imag) written once.  The kernel's
    # DFT product does 2 * taps * 2F FLOP per frame instead, so it sits far
    # above this bound by construction.
    b, t = x.shape
    frames, freq = real.shape[1], real.shape[2]
    flops = b * frames * (2.5 * n_fft * np.log2(n_fft) + n_fft)
    nbytes = 4.0 * (b * t + n_fft + 2 * b * frames * freq)
    lo, hi = window_taps(n_fft, win)
    dft_flops = 2.0 * b * frames * (hi - lo) * 2 * freq
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "shape": [b, t], "n_fft": n_fft, "hop": hop, "win": win,
        "max_abs_err": err, "err_vs_torch_stft": lib_err, "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes, "dft_flops": dft_flops,
        "dft_tflops_per_s": dft_flops / ms * 1e-9,
    }


# --------------------------------------------------------------------------- #
# the spec-conv kernels


def spec_conv_numbers(shape, kt: int, stride: int, flush: torch.Tensor,
                      seed: int) -> dict:
    """Forward, dgrad and wgrad at one MRD layer shape: each kernel held
    against its plain version and timed beside it, cuDNN's bf16
    channels-last call and its bound."""
    import torch.nn.functional as F

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
    runs = {
        "forward": (lambda: sc.spec_conv_forward(x, wt, bias, stride, 0.1),
                    lambda: sc.forward_plain(x, wt, bias, stride, 0.1),
                    lambda: F.conv2d(x_cl, wt, bias, stride=(1, stride),
                                     padding=pad),
                    2 * (x.numel() + wt.numel() + bias.numel()
                         + b * h * w_out * c)),
        "dgrad": (lambda: sc.spec_conv_dgrad(d, wt, w, stride),
                  lambda: sc.dgrad_plain(d, wt, w, stride),
                  lambda: torch.nn.grad.conv2d_input(
                      (b, c, h, w), wt, d_cl, stride=(1, stride),
                      padding=pad),
                  2 * (d.numel() + wt.numel() + x.numel())),
        "wgrad": (lambda: sc.spec_conv_wgrad(x, d, kt, stride),
                  lambda: sc.wgrad_plain(x, d, kt, stride),
                  lambda: torch.nn.grad.conv2d_weight(
                      x_cl, (c, c, 3, kt), d_cl, stride=(1, stride),
                      padding=pad),
                  2 * (x.numel() + d.numel()) + 4 * wt.numel()),
    }
    flops = 2.0 * b * h * w_out * 3 * kt * c * c
    out = {}
    for name, (kernel, plain, library, nbytes) in runs.items():
        counter = getattr(sc, f"spec_conv_{name}")
        before = counter.launches
        got = kernel()
        if counter.launches != before + 1:
            raise AssertionError(f"spec_conv_{name}: no kernel launch")
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"spec_conv_{name}: {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not err <= CONV_TOL[name] * scale:
            raise AssertionError(f"spec_conv_{name} {shape}: max err "
                                 f"{err:.3e} > {CONV_TOL[name]} * {scale:.3e}")
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        ms = time_ms(kernel, flush=flush)
        out[name] = {
            "shape": list(shape), "kt": kt, "stride": stride,
            "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
            "plain_ms": time_ms(plain, iters=3, flush=flush),
            "library_ms": time_ms(library, flush=flush),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "tflops_per_s": flops / ms * 1e-9,
        }
        del got, want
    return out


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
    per_step = {k: v / 3 for k, v in launches.items()}
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
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "top": [{"ms": d, "count": c, "name": k} for d, c, k in rows[:40]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import copy

    from stylish_tts_tpu_torch.config import ModelConfig
    from stylish_tts_tpu_torch.device import resolve_device
    from stylish_tts_tpu_torch.export.infer import Synthesizer, frame_bucket
    from stylish_tts_tpu_torch.ops import spec_conv as sc
    from stylish_tts_tpu_torch.ops.build import build, build_log
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
    stems = ["spec_conv", "stft"]  # every source of csrc/
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
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"torch.stft {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f}"
              f" ms ({r['bound_by']}), DFT product at "
              f"{r['dft_tflops_per_s']:.1f} TFLOP/s, max err "
              f"{r['max_abs_err']:.2e} (vs torch.stft "
              f"{r['err_vs_torch_stft']:.2e}) [{card}]")
    del x
    # ... and the spec-conv kernels at the MRD's layer shapes
    record["spec_conv"] = {}
    for seed, (label, shape, kt, stride) in enumerate(CONV_SHAPES):
        r = spec_conv_numbers(shape, kt, stride, flush, seed)
        record["spec_conv"][label] = r
        for name, n in r.items():
            print(f"spec_conv_{name} {label} {shape} kt={kt} s={stride}: "
                  f"kernel {n['ms']:.3f} ms ({n['tflops_per_s']:.1f} TFLOP/s)"
                  f", plain {n['plain_ms']:.3f} ms, cuDNN bf16 "
                  f"{n['library_ms']:.3f} ms, bound {n['bound_ms']:.3f} ms "
                  f"({n['bound_by']}), max err {n['max_abs_err']:.2e} of "
                  f"{n['max_abs_plain']:.2e} [{card}]")
    torch.cuda.empty_cache()

    # 3. synthesis at full width
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
    t_single, t_batch = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        audio = synth.synthesize(single, fixed_duration=8)
        t_single.append(time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        audios = synth.synthesize_batch(batch, fixed_duration=8)
        t_batch.append(time.perf_counter() - t0)
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
        "launches": synth_launches, "card": card,
    }
    for name, sec, walls in (("synthesize", sec_single, t_single),
                             ("synthesize_batch(8)", sec_batch, t_batch)):
        print(f"{name}: {sec:.2f} s of audio in "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, RTF "
              f"{sec / float(np.median(walls)):.1f}x (median) [{card}]")

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
          f"{record['stft_main_path_single']['shape']}: kernel "
          f"{main['ms']:.3f} ms, plain {main['plain_ms']:.3f} ms, torch.stft "
          f"{main['library_ms']:.3f} ms, bound {main['bound_ms']:.3f} ms "
          f"({main['bound_by']}), DFT product at "
          f"{main['dft_tflops_per_s']:.1f} TFLOP/s, "
          f"max err {main['max_abs_err']:.2e} (vs torch.stft "
          f"{main['err_vs_torch_stft']:.2e}) [{card}]")

    if "--profile" in sys.argv[1:]:
        record["profile"] = profile_batch(synth, batch, card)

    worst = cpu_vs_card(mc, models_cpu, synth, batch[0][:20])
    print(f"full-width models, cpu vs card on 20 phonemes: worst relative "
          f"error {worst:.2e}")
    del synth, models, models_cpu
    torch.cuda.empty_cache()

    # 4. training: the acoustic step at full width
    train, state, step, tbatch, gen = train_path(mc, device, card, kernels)
    record["train"] = train
    # the STFT at the train step's largest shape: the magphase target and
    # the posterior encoder, [8, 138000] at n_fft 2048, hop 75
    train_stft = stft_numbers(tbatch["audio_gt"], mc.n_fft, hop // 4,
                              mc.win_length, flush)
    record["stft_train_path"] = train_stft
    print(f"stft at the train step's shape {train_stft['shape']}: kernel "
          f"{train_stft['ms']:.3f} ms, plain {train_stft['plain_ms']:.3f} ms,"
          f" torch.stft {train_stft['library_ms']:.3f} ms, bound "
          f"{train_stft['bound_ms']:.3f} ms, max err "
          f"{train_stft['max_abs_err']:.2e} [{card}]")
    if "--profile" in sys.argv[1:]:
        record["profile_train"] = profile_step(step, state, tbatch, gen,
                                               card)
    del state, step, tbatch, gen
    torch.cuda.empty_cache()
    record["train_cpu_vs_card"] = cpu_vs_card_step(mc, card)

    # 5. results: each kernel's own numbers; launches from the train step
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    numbers = {"stft_forward": train_stft}
    for name in ("forward", "dgrad", "wgrad"):
        numbers[f"spec_conv_{name}"] = record["spec_conv"]["res0 conv_1"][name]
    entries = []
    for k in kernels:
        n = numbers[k.name]
        entries.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": train["launches"][k.name],
            "max_abs_err": n["max_abs_err"], "ms": n["ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"], "library_ms": n["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

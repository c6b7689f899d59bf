"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit, CUDA version, and the build of
   every kernel of the port from ``stylish_tts_tpu_torch/csrc``;
2. kernel vs plain: each kernel on random f32 input at its shapes, held
   against its plain PyTorch version, with its time, the plain version's,
   a library call's (a yardstick the port never calls) and its bound;
3. main path: ``Synthesizer`` at the default full-width ModelConfig with
   seeded random weights serves one ``synthesize`` of 80 phonemes and one
   ``synthesize_batch`` of 8 utterances; every kernel's launch count is set
   to 0 just before and read just after, and the audio is checked (finite,
   not silent, exactly total_frames * hop samples); the kernels are held
   against their plain versions again at the shapes this path gave them,
   and the full-width model's CPU and card outputs are compared on a short
   input;
4. one JSON line of every kernel's numbers, then the result line.

``--profile`` adds a torch.profiler breakdown of one batch request: device
time by kernel and the device's busy share of the wall time.

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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

STFT_SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
               (2048, 240, 1200), (2048, 300, 1200)]
KERNEL_TOL = 1e-4  # max|kernel - plain| <= KERNEL_TOL * max|plain|


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
    rows = []
    for evt in prof.key_averages():  # kernels only: operators would count
        if evt.device_type != torch.autograd.DeviceType.CUDA:  # them twice
            continue
        rows.append((evt.self_device_time_total / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"profile synthesize_batch(8): wall {wall_ms:.1f} ms, kernels "
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
    from stylish_tts_tpu_torch.ops.build import build_log, load_library
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    kernels = [stft_forward]
    record = {}

    # 1. device and build
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    load_library("stft")
    print(f"build: stft {time.perf_counter() - t0:.1f} s")
    for line in build_log("stft").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain at the five STFT shapes, B=4, 10 s at 24 kHz
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

    # 3. the main path at full width
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
    launches = {k.name: k.launches for k in kernels}
    for k in kernels:
        if launches[k.name] == 0:
            raise AssertionError(f"{k.name} never launched on the main path")
    print(f"main path launches: {launches}")

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
        "card": card,
    }
    for name, sec, walls in (("synthesize", sec_single, t_single),
                             ("synthesize_batch(8)", sec_batch, t_batch)):
        print(f"{name}: {sec:.2f} s of audio in "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, RTF "
              f"{sec / float(np.median(walls)):.1f}x (median) [{card}]")

    # the kernel against its plain version at the shapes this path gave it:
    # the prior of the batch request, [8, frames * 300] at the generator's
    # hop; its numbers go into the kernels line
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
    print(f"stft at the main path's shapes {main['shape']} and "
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

    # 4. results
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    entries = []
    for k in kernels:
        entries.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

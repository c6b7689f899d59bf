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
8. from a book to a voice, at the full-width default ModelConfig, each
   step through the CLI's ``main`` but the first two, which call the
   CLI's functions with an argument the CLI leaves at its default: a
   two-chapter markdown book of 40 sentences (numbers, abbreviations,
   homographs) is read by ``speak --book``'s ``speak_book`` on phase 4's
   seeded models (their duration head at a speech rate, their magnitude a
   180 Hz comb) with 0.5 s between sentences, each chapter's WAV exactly
   the synthesizer's long-form result (every sentence its predicted
   frames x hop samples); ``prepare-book``'s ``prepare_book`` (no
   transcripts, a fifth of the segments for val) cuts them into a dataset
   whose lines have 4 fields and phonemes in the symbol set; ``pitch`` (YIN)
   writes a finite track of samples // hop + 1 frames a segment, some
   voiced; ``train-align`` takes a few steps (at most one epoch) with a
   validation after a pass over the val set and a save: the aligner
   moved, the priors set at the epoch's end, its file written, finite
   ``align_loss`` and ``confidence``, the STFT launched at every step and
   the spec-conv kernels never; ``align`` writes durations that sum to
   each segment's frames, boundary probabilities in [0, 1] and a score a
   segment; the STFT is held against its plain version at every shape
   those two gave it; one acoustic step of ``train`` reads the new caches;
   last ``speak --text`` reads three sentences on phase 7's artifact.
   Each step's seconds, launches and segment counts printed;
9. interop and the joint stage, at the full-width default ModelConfig:
   a torch reference checkpoint of the chain's models and the aligner,
   drawn from a seed (``utils/synthetic.py:write_reference_checkpoint``,
   the speech predictor, the MRD and the mel style encoder as
   ``model_N.safetensors``, the rest as ``pytorch_model_N.bin``);
   ``import-torch`` through the CLI's ``main``, every tensor of the
   artifact equal to the in-process conversion of the same state dicts and
   its config's ``reference_band_mask`` on, then ``speak --phonemes`` of 80
   phonemes from it checked as in phase 4, and ``import-torch --model
   text_aligner`` on the aligner's file loaded into the port's aligner
   (every tensor equal to its source); a 12-layer SLM weights file from a
   seed under the flax names; ``train --stage joint --init-torch`` with
   ``slm.weights_path`` on phase 7's dataset for JOINT_STEPS steps (the
   heuristic plan, batches of up to JOINT_BATCH), a validation and a save
   every JOINT_INTERVAL, where a hook at the stage's start holds the
   state's models equal to the converted reference and the loop's SLM to
   the file, tensor for tensor; after it the four joint models and the MRD
   moved, the mel style encoder (``u``/``sigma`` too) and the duration
   predictor are bit-equal, the metrics and validation losses finite, and
   every step launched the STFT and the spec-conv kernels as often as its
   spectrograms and the MRD's 12 layers give (STFT_PER_STEP,
   ``LAUNCHES_PER_LAYER``; the acoustic step's counts of phase 5), every
   eval batch the STFT as its spectrograms give and no spec-conv kernel;
   at every batch shape the stage took the STFT and the spec-conv kernels
   are held against their plain versions as in phase 7; last CLI ``test``
   at its defaults: every row of its parameter table the count of the
   joint state's module (the aligner's of the imported one, the
   experimental stages' models' of freshly built ones), and its
   timed forward launched the STFT once a call.  Each command's seconds,
   the artifact's bytes, each joint step's wall ms (first visit of its
   shape, or warm) and ``test``'s ms/batch and x real time printed;
10. the experimental stages, at the full-width default ModelConfig on
   phase 7's dataset: a HuBERT-base encoder (6 layers, 768 wide), a
   SimAM-ResNet34 speaker net (10240-d) and a Vocos written from a seed as
   flat safetensors of their flax names and passed through
   ``hubert.weights_path``, ``speaker_embedder.weights_path`` and
   ``training.vocos_weights``; CLI ``train`` through the CLI's ``main``
   for ``hubert_acoustic`` (4 steps), ``cfm_hubert_pitch`` (4 steps),
   ``cfm_hubert_mel`` with the model's mel (4 steps, Griffin-Lim
   validation) and with Vocos's (2 steps, Vocos validation), each with a
   validation at its last step, batches of up to EXPERIMENTAL_BATCH (the
   heuristic plan).  A hook at each run's start holds the frozen nets the
   loop built equal to their files, tensor for tensor.  Checked after each
   run: the checkpoint holds the six experimental models; every trained
   model moved and every other one is bit-equal, but the hubert encoder in
   ``cfm_hubert_mel``, which moved by exactly AdamW's decay (no loss
   reaches it); finite metrics and validation losses; the validation
   audio finite, not silent and of the expected length (none for
   ``cfm_hubert_pitch``); every train step and eval batch launched the
   STFT as its spectrograms give (EXPERIMENTAL_STFT) and the spec-conv
   kernels only in ``hubert_acoustic``, as the MRD's 12 layers give; then
   the STFT and the spec-conv kernels are held against their plain
   versions at every batch shape the runs took as in phase 7, the STFT
   also at Vocos's 1024/256/1024 setting, which is timed; last one f32
   ``hubert_acoustic`` step at full width on 1 x 64 frames on the CPU and
   on the card, its metrics within STEP_TOL.  Each run's seconds and each
   step's wall ms (first visit of its shape, or warm) printed;
11. one JSON line of every kernel's numbers, with its launches on the path
   that runs it (per train step, acoustic, joint and each experimental
   run, synthesis request or probe run), then the result line.

``--profile`` adds torch.profiler breakdowns of one batch request and of
one train step: device time by kernel, the port's own kernels' totals,
and the device's busy share of the wall time.

Numbers beyond the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
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
# the interop phase: the reference checkpoint's models written as
# safetensors (the rest as torch pickles), and the joint stage of CLI train
# on phase 7's dataset: JOINT_STEPS steps of batches of up to JOINT_BATCH
# (the heuristic plan), a validation and a save every JOINT_INTERVAL
REFERENCE_SAFETENSORS = ("speech_predictor", "mrd", "pe_mel_style_encoder")
JOINT_STEPS, JOINT_INTERVAL, JOINT_BATCH = 6, 3, 8
# the experimental stages' phase on phase 7's dataset: (run, stage,
# cfm_mel_features, steps), batches of up to EXPERIMENTAL_BATCH (the
# heuristic plan), a validation at the last step; the CFM mel runs at an LR
# where AdamW's decay factor 1 - lr * 1e-4 is not 1 in f32, so the hubert
# encoder, which no loss reaches, moves by it
EXPERIMENTAL_RUNS = (
    ("hubert_acoustic", "hubert_acoustic", "model", 4),
    ("cfm_hubert_pitch", "cfm_hubert_pitch", "model", 4),
    ("cfm_hubert_mel", "cfm_hubert_mel", "model", 4),
    ("cfm_hubert_mel_vocos", "cfm_hubert_mel", "vocos", 2),
)
EXPERIMENTAL_BATCH, EXPERIMENTAL_MEL_LR = 8, 1e-3
VOCOS_STFT = (1024, 256, 1024)  # Vocos's features: n_fft, hop, win
GRIFFIN_LIM_ITERS = 32  # ops/griffin_lim.py:mel_to_audio's default
# STFT launches of a GAN stage's train step: the mel, the multi-resolution
# spectrograms of target and prediction (3 each), the magphase target, the
# posterior encoder's input and the generator's prior; of its eval step:
# the mel, the 6 spectrograms and the prior
STFT_PER_STEP = {"train": 1 + 2 * 3 + 1 + 1 + 1, "eval": 1 + 2 * 3 + 1}
# ... and of the experimental runs: hubert_acoustic's as a GAN stage's;
# the CFM stages' train step only its mel; the CFM mel eval batch its mel
# and Griffin-Lim's iterations (the Vocos run: only its mel)
EXPERIMENTAL_STFT = {
    "hubert_acoustic": STFT_PER_STEP,
    "cfm_hubert_pitch": {"train": 1, "eval": 1},
    "cfm_hubert_mel": {"train": 1, "eval": 1 + GRIFFIN_LIM_ITERS},
    "cfm_hubert_mel_vocos": {"train": 1, "eval": 1},
}


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


def chain_path(device, card: str, kernels, keep_artifact: Path,
               data: Path) -> dict:
    """CLI ``train`` through acoustic -> textual -> style -> duration at
    full width on a synthetic dataset written to ``data``, with the
    measured memory plan; then ``convert`` and ``speak`` through the CLI,
    the artifact copied to ``keep_artifact``; see the module docstring,
    phase 7."""
    import functools
    import shutil
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
        out = root / "out"
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
        shutil.copytree(artifact, keep_artifact)
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
# from a book to a voice: speak --book, prepare-book, pitch, train-align,
# align, train, speak --text through the CLI


# a two-chapter markdown book: numbers, abbreviations and homographs
BOOK_CHAPTERS = (
    ("The Lighthouse", (
        "Dr. Hale read the old record of the lighthouse on the 3rd of May.",
        "The keeper had kept 12 lamps burning for 25 years.",
        "He paid $40 for a lead weight and 2 coils of rope.",
        "Mr. Grant would lead the boats past the rocks at dawn.",
        "They record the wind and the tide in a small blue book.",
        "Each entry was written at 6 o'clock sharp, rain or shine.",
        "In 1887 a storm broke 3 windows and the great lens.",
        "The crew read every letter aloud by the fire that night.",
        "A record crowd of 150 people came to watch the repairs.",
        "Mrs. Hale said the light must never go out again.",
        "So the keeper climbed 98 steps each evening at sunset.",
        "The lead pipe in the tower rattled when the gale rose.",
        "He wound the clock, trimmed the wick and cleaned the glass.",
        "Ships far out at sea would read the flash as a warning.",
        "By the 21st of June the new lens was finally in place.",
        "It cost the town nearly $2,500, a fortune at the time.",
        "The children live close to the harbor and love the light.",
        "On clear nights it shone for 18 miles across the water.",
        "Dr. Hale wrote that the old keeper never missed a night.",
        "The last page of his record ends with a single word: home.",
    )),
    ("The Orchard", (
        "Prof. Lane planted 40 apple trees along the south wall.",
        "She would read about grafting late into the night.",
        "The first harvest, in 1902, filled only 7 baskets.",
        "Her neighbors said the soil held too much lead and clay.",
        "She tested it twice and kept a careful record of each result.",
        "By the 2nd year the trees gave three times as much fruit.",
        "A buyer from the city paid $3.50 for each crate.",
        "Lane let her students lead the tours on Saturday mornings.",
        "They learned to prune, to graft and to read the weather.",
        "One cold spring, frost killed half the blossoms in a week.",
        "St. Mary's school sent 60 pupils to help with the picking.",
        "The orchard now covers 12 acres on the hill above the river.",
        "Each tree has a tag and a record of its yield since planting.",
        "Visitors who live nearby still come to walk among the rows.",
        "The oldest tree is 118 years old and still bears fruit.",
        "Lane's notes fill 14 notebooks in the town library.",
        "Students read them to learn how the orchard began.",
        "A plaque by the gate gives the date: the 9th of April.",
        "The wind in the branches sounds like rain on a tin roof.",
        "At dusk the whole hill smells of cider and cut grass.",
    )),
)
BOOK_PAUSE_MS = 500  # silence between sentences: phrase breaks
BOOK_F0 = 180.0  # Hz, the voice's harmonics
BOOK_VAL_FRACTION = 0.2
# train-align: a few steps of at most one epoch, validating (after a pass
# over the val set) and saving every BOOK_INTERVAL steps
BOOK_ALIGN_STEPS, BOOK_INTERVAL, BOOK_PROBE_BATCH = 4, 2, 4
SPEAK_TEXT = ("The keeper read the record twice. It was the 3rd of May, "
              "at 6 p.m. Dr. Hale paid $40 for the lead weight.")


@torch.no_grad()
def book_levels(mc, models):
    """``speech_levels``' models read at a speech rate and voiced: the
    duration head at about 5-6 frames (62-75 ms) a phoneme, where random
    weights spread the classes to 46 frames; and the log-amplitude head's
    bias a comb at the harmonics of 180 Hz below 5 kHz.  Random weights
    give an aperiodic spectrum, noise to YIN whatever the prior's F0; a
    harmonic magnitude makes each frame periodic whatever the phase head
    gives it (99.5% of the frames voiced on a full-width sentence on the
    CPU)."""
    dp = models["duration_predictor"].duration_proj
    dp.weight.mul_(0.2)
    dp.bias.zero_()
    dp.bias[4] = 4.0  # 5 frames
    dp.bias[5] = 3.0  # 6
    amp = models["speech_predictor"].generator.amp_output_conv.Conv_0
    harmonic = torch.arange(amp.bias.shape[0]) * (
        mc.sample_rate / mc.n_fft) / BOOK_F0
    near = (harmonic - torch.round(harmonic)).abs() < 0.12
    amp.bias.copy_(torch.where(near & (harmonic > 0.5)
                               & (harmonic * BOOK_F0 < 5000.0), 1.5, -6.0))
    return models


def write_artifact(mc, models, out: Path) -> Path:
    """An inference artifact of ``models`` (the layout ``convert``
    writes)."""
    from stylish_tts_tpu_torch.config import dump_json
    from stylish_tts_tpu_torch.convert import export_flax_params
    from stylish_tts_tpu_torch.models import INFERENCE_MODELS
    from stylish_tts_tpu_torch.utils.tensorfile import write_safetensors

    out.mkdir(parents=True)
    for key in INFERENCE_MODELS:
        write_safetensors(out / f"{key}.safetensors",
                          export_flax_params(key, models[key]))
    (out / "model_config.json").write_text(dump_json(mc))
    return out


def read_pcm(path: Path) -> np.ndarray:
    import wave

    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


@contextlib.contextmanager
def watch_longform():
    """While the block runs, every sentence a ``Synthesizer`` synthesizes
    is checked to be its predicted frames x hop samples, finite and not
    silent (before the long-form trim), and each long-form result is kept
    as the int16 PCM that ``speak`` writes of it; yields (those PCMs, the
    sentences' sample counts)."""
    from stylish_tts_tpu_torch.export.infer import Synthesizer

    single, longform = Synthesizer.synthesize, Synthesizer.synthesize_longform
    pcms, sentences = [], []

    def synthesize(self, phonemes, *args, **kwargs):
        audio = single(self, phonemes, *args, **kwargs)
        frames = int(self.predict_durations(phonemes).sum())
        check_audio(audio, frames, 1, self.mc.hop_length, "a sentence")
        sentences.append(audio.shape[0])
        return audio

    def synthesize_longform(self, *args, **kwargs):
        audio = longform(self, *args, **kwargs)
        pcms.append((np.clip(audio, -1, 1) * 32767).astype("<i2"))
        return audio

    Synthesizer.synthesize = synthesize
    Synthesizer.synthesize_longform = synthesize_longform
    try:
        yield pcms, sentences
    finally:
        Synthesizer.synthesize = single
        Synthesizer.synthesize_longform = longform


def check_written(path: Path, pcm: np.ndarray, what: str) -> None:
    """The WAV at ``path`` holds exactly ``pcm``, which is not silent."""
    written = read_pcm(path)
    if not np.array_equal(written, pcm) or not np.abs(pcm).max():
        raise AssertionError(f"{what}: {written.shape} samples written, the "
                             f"synthesizer gave {pcm.shape} (max "
                             f"{np.abs(pcm).max() if pcm.size else 0})")


def _record_stft_shapes(shapes: list):
    """Wrap the STFT wrapper's launch so that each launch's (B, T, n_fft,
    hop, win) lands in ``shapes``; returns the restore."""
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    launch = stft_forward.launch

    def recording(x, n_fft, hop_length, win_length):
        shapes.append((*x.shape, n_fft, hop_length, win_length))
        return launch(x, n_fft, hop_length, win_length)

    stft_forward.launch = recording
    return lambda: setattr(stft_forward, "launch", launch)


def book_path(card: str, kernels, chain_artifact: Path) -> dict:
    """From a book's text to a voice through the CLI, at the full-width
    default ModelConfig; see the module docstring, phase 8."""
    import functools
    import shutil
    import tempfile

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, ModelConfig, dump_json
    from stylish_tts_tpu_torch.data.audio import wav_info
    from stylish_tts_tpu_torch.dataprep.book import (prepare_book,
                                                     split_markdown_chapters)
    from stylish_tts_tpu_torch.text import TextCleaner
    from stylish_tts_tpu_torch.textfrontend import G2P
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

    t_phase = time.perf_counter()
    mc = ModelConfig()
    hop = mc.hop_length
    record: dict = {"card": card, "seconds": {}, "events": [], "stages": {}}
    seconds = record["seconds"]
    g2p = G2P()
    record["g2p"] = f"espeak ({g2p.espeak})" if g2p.espeak else \
        "lexicon and rules (no espeak on the path)"
    md = "".join(f"# {title}\n\n" + " ".join(body) + "\n\n"
                 for title, body in BOOK_CHAPTERS)
    n_sentences = sum(len(b) for _, b in BOOK_CHAPTERS)
    t0 = time.perf_counter()
    for _, body in BOOK_CHAPTERS:
        cli.text_to_phonemes(" ".join(body), g2p)
    seconds["g2p"] = time.perf_counter() - t0
    print(f"book: {len(BOOK_CHAPTERS)} chapters, {n_sentences} sentences; "
          f"G2P {record['g2p']}, {1e3 * seconds['g2p'] / n_sentences:.2f} "
          f"ms a sentence [{card}]")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_book_") as tmp:
        root = Path(tmp)
        artifact = write_artifact(
            mc, book_levels(mc, seeded_models(mc, seed=0)),
            root / "artifact")
        (root / "book.md").write_text(md)
        chapters = split_markdown_chapters(md)
        (root / "book.txt").write_text("\n\n".join(b for _, b in chapters))

        # the book: one WAV a chapter, each what the synthesizer gives.
        # ``speak --book``'s function, for its pause: the CLI's 120 ms
        # between sentences is too short a silence for prepare-book's
        # phrase detection, where a reader's pauses are longer
        t0 = time.perf_counter()
        with watch_longform() as (want, sentences):
            cli.speak_book(str(artifact), str(root / "book.md"),
                           str(root / "chapters"), pause_ms=BOOK_PAUSE_MS)
        seconds["speak_book"] = time.perf_counter() - t0
        wavs = sorted((root / "chapters").glob("chapter-*.wav"))
        if len(wavs) != len(BOOK_CHAPTERS) or len(want) != len(wavs):
            raise AssertionError(f"speak --book wrote {len(wavs)} WAVs of "
                                 f"{len(want)} chapters")
        if len(sentences) != n_sentences:
            raise AssertionError(f"{len(sentences)} sentences synthesized")
        for path, pcm in zip(wavs, want):
            check_written(path, pcm, path.name)
        record["chapters"] = [int(pcm.shape[0]) for pcm in want]
        audio_s = sum(record["chapters"]) / mc.sample_rate
        print(f"book: speak --book {seconds['speak_book']:.1f} s for "
              f"{audio_s:.1f} s of audio in {len(wavs)} chapters of "
              f"{record['chapters']} samples, each as synthesized (each "
              f"sentence its predicted frames x {hop} samples: "
              f"{sum(sentences)} samples in {n_sentences}) [{card}]")

        # the dataset.  ``prepare-book``'s function, for its val share:
        # the CLI's 3% gives a 40-sentence book no val segment to
        # validate the aligner on
        data = root / "data"
        t0 = time.perf_counter()
        made = prepare_book(
            audio_files=[str(p) for p in wavs],
            book_text_file=str(root / "book.txt"), out_dir=str(data),
            sample_rate=mc.sample_rate, val_fraction=BOOK_VAL_FRACTION)
        seconds["prepare_book"] = time.perf_counter() - t0
        print(f"book: prepare-book {json.dumps(made)}")
        cleaner = TextCleaner(mc.symbol)
        lists = {}
        for split in ("train", "val"):
            lines = (data / f"{split}-list.txt").read_text().splitlines()
            lists[split] = [line.split("|") for line in lines]
            for fields in lists[split]:
                if len(fields) != 4 or fields[2] != "0" or not fields[3]:
                    raise AssertionError(f"{split} list line {fields}")
                if not fields[1] or len(cleaner(fields[1])) != len(
                        fields[1]):
                    raise AssertionError(f"phonemes outside the symbol set: "
                                         f"{fields[1]!r}")
                if not (data / "wav24" / fields[0]).is_file():
                    raise AssertionError(f"{fields[0]} not written")
        if not lists["train"] or not lists["val"]:
            raise AssertionError(f"segments: {len(lists['train'])} train, "
                                 f"{len(lists['val'])} val")
        segments = {f[0]: wav_info(data / "wav24" / f[0]).frames
                    for split in lists.values() for f in split}
        record["segments"] = {"train": len(lists["train"]),
                              "val": len(lists["val"]),
                              "seconds": sum(segments.values())
                              / mc.sample_rate}
        print(f"book: prepare-book {seconds['prepare_book']:.1f} s: "
              f"{record['segments']} [{card}]")

        cfg = Config()
        cfg.dataset.path = str(data)
        cfg.training_plan.alignment.epochs = 1
        cfg.training_plan.alignment.probe_batch_max = BOOK_PROBE_BATCH
        cfg.training_plan.acoustic.probe_batch_max = 1
        cfg.training.log_interval = 1
        cfg.training.val_interval = cfg.training.save_interval = \
            BOOK_INTERVAL
        cfg.training.aot_memory_plan = False
        (root / "config.json").write_text(dump_json(cfg))
        config = ["--config", str(root / "config.json")]

        # pitch
        t0 = time.perf_counter()
        cli.main(["pitch", *config])
        seconds["pitch"] = time.perf_counter() - t0
        pitch = read_safetensors(data / "pitch.safetensors")
        if set(pitch) != set(segments):
            raise AssertionError(f"pitch for {len(pitch)} of "
                                 f"{len(segments)} segments")
        for name, f0 in pitch.items():
            if f0.shape != (segments[name] // hop + 1,) or not np.all(
                    np.isfinite(f0)):
                raise AssertionError(f"{name}: f0 {f0.shape}")
        voiced = float(np.mean(np.concatenate(list(pitch.values())) > 0))
        if not voiced > 0:
            raise AssertionError("no voiced frame")
        record["voiced_share"] = voiced
        print(f"book: pitch {seconds['pitch']:.1f} s, {len(pitch)} tracks, "
              f"{100 * voiced:.1f}% of the frames voiced [{card}]")

        # the aligner
        align_shapes: list = []
        restore = _record_stft_shapes(align_shapes)
        original = loop.train_model
        loop.train_model = functools.partial(
            original, on_stage=_stage_hook(kernels, record))
        t0 = time.perf_counter()
        try:
            cli.main(["train-align", *config, "--out", str(root / "align"),
                      "--max-steps", str(BOOK_ALIGN_STEPS)])
        finally:
            loop.train_model = original
        seconds["train_align"] = time.perf_counter() - t0
        stats = json.loads((root / "align" / "alignment" / "train_stats.json")
                           .read_text())
        seen = record["stages"]["alignment"]
        launches = seen["launches"]
        if record["events"] != [["start", "alignment"],
                                ["planned", "alignment"],
                                ["end", "alignment"]]:
            raise AssertionError(f"stage events {record['events']}")
        if not 1 <= stats["steps"] <= BOOK_ALIGN_STEPS:
            raise AssertionError(f"train-align took {stats['steps']} steps")
        if not seen["moved"]["text_aligner"]["params"]:
            raise AssertionError("the aligner did not move")
        priors = read_safetensors(root / "align" / "alignment"
                                  / "checkpoint_final" / "priors.safetensors")
        if not priors["priors_initialized"] or not np.all(
                np.isfinite(priors["log_priors"])):
            raise AssertionError("the priors were not set at the epoch's end")
        if not (root / "align" / "alignment_model.safetensors").is_file():
            raise AssertionError("alignment_model.safetensors not written")
        values = [e["metrics"]["align_loss"] for e in stats["logs"]] + [
            v["metrics"][k] for v in stats["validations"]
            for k in ("align_loss", "confidence")]
        if not stats["validations"] or not stats["saves"] or not all(
                np.isfinite(values)):
            raise AssertionError(f"train-align: validations "
                                 f"{stats['validations']}, saves "
                                 f"{stats['saves']}")
        mel_launches = sum(1 for s in align_shapes if s[3] == hop)
        if launches["stft_forward"] < stats["steps"] or \
                mel_launches != launches["stft_forward"]:
            raise AssertionError(f"train-align: {launches['stft_forward']} "
                                 f"STFT launches, {stats['steps']} steps")
        if any(n for k, n in launches.items() if k.startswith("spec_conv")):
            raise AssertionError(f"train-align launched the MRD: {launches}")
        record["train_align"] = {"steps": stats["steps"],
                                 "batches": stats["batches"],
                                 "launches": launches,
                                 "validations": stats["validations"],
                                 "logs": stats["logs"]}
        print(f"book: train-align {seconds['train_align']:.1f} s, "
              f"{stats['steps']} steps {stats['batches']}, align_loss "
              f"{[round(e['metrics']['align_loss'], 3) for e in stats['logs']]}"
              f", validation "
              f"{[{k: round(v, 4) for k, v in e['metrics'].items()} for e in stats['validations']]}"
              f"; launches {launches} [{card}]")

        # alignment
        shutil.copy(root / "align" / "alignment_model.safetensors", data)
        n_train_align = len(align_shapes)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            cli.main(["align", *config])
        finally:
            restore()
        seconds["align"] = time.perf_counter() - t0
        align_launches = {k.name: k.launches for k in kernels}
        batches = len(align_shapes) - n_train_align
        if not batches or align_launches["stft_forward"] != batches:
            raise AssertionError(f"align: {align_launches} over {batches} "
                                 f"batches")
        records = read_safetensors(data / "alignment.safetensors")
        if set(records) != set(segments):
            raise AssertionError(f"alignments for {len(records)} of "
                                 f"{len(segments)} segments")
        for name, rec in records.items():
            frames = segments[name] // hop
            if rec.shape[0] != 3 or int(rec[0].sum()) != frames:
                raise AssertionError(f"{name}: durations sum to "
                                     f"{rec[0].sum()}, {frames} frames")
            if not np.all((rec[1:] >= 0) & (rec[1:] <= 1)):
                raise AssertionError(f"{name}: boundary probabilities out "
                                     f"of [0, 1]")
        for split, fields in lists.items():
            scored = (data / f"scores_{split}.txt").read_text().splitlines()
            if [s.split()[1] for s in scored] != [f[0] for f in fields]:
                raise AssertionError(f"scores_{split}.txt lines")
            if not all(0 <= float(s.split()[0]) <= 1 for s in scored):
                raise AssertionError(f"scores_{split}.txt values")
        record["align"] = {"batches": batches, "launches": align_launches}
        print(f"book: align {seconds['align']:.1f} s, {len(records)} "
              f"segments in {batches} batches "
              f"{sorted(set(s[:2] for s in align_shapes[n_train_align:]))}; "
              f"launches {align_launches} [{card}]")

        # the STFT at every shape train-align and align gave it
        t0 = time.perf_counter()
        worst = 0.0
        for b, t, n_fft, hop_length, win in sorted(set(align_shapes)):
            gen = torch.Generator(device="cuda").manual_seed(b * t)
            x = torch.randn(b, t, generator=gen, device="cuda")
            worst = max(worst, stft_error(x, n_fft, hop_length, win)[2])
        record["stft_shapes"] = sorted(set(align_shapes))
        record["stft_max_abs_err"] = worst
        print(f"book: stft at the {len(set(align_shapes))} shapes of "
              f"train-align and align within {KERNEL_TOL} x the largest "
              f"plain value (max err {worst:.2e}), "
              f"{time.perf_counter() - t0:.2f} s [{card}]")

        # a voice: one acoustic step on the dataset's new caches
        t0 = time.perf_counter()
        cli.main(["train", *config, "--out", str(root / "voice"),
                  "--max-steps", "1"])
        seconds["train_step"] = time.perf_counter() - t0
        stats = json.loads((root / "voice" / "acoustic" / "train_stats.json")
                           .read_text())
        if stats["steps"] != 1 or not all(
                np.isfinite(list(stats["logs"][0]["metrics"].values()))):
            raise AssertionError(f"train on the book: {stats['logs']}")
        print(f"book: train --max-steps 1 {seconds['train_step']:.1f} s, "
              f"batch {stats['batches']}, loss "
              f"{stats['logs'][0]['loss']:.3f} [{card}]")

        # speak --text on the chain's artifact
        (root / "speak.txt").write_text(SPEAK_TEXT)
        t0 = time.perf_counter()
        with watch_longform() as (want, sentences):
            cli.main(["speak", "--artifact", str(chain_artifact), "--text",
                      str(root / "speak.txt"), "--out",
                      str(root / "speak.wav")])
        seconds["speak_text"] = time.perf_counter() - t0
        if len(want) != 1 or len(sentences) != 3:
            raise AssertionError(f"speak --text: {len(want)} long-form "
                                 f"results of {len(sentences)} sentences")
        (pcm,) = want
        check_written(root / "speak.wav", pcm, "speak --text")
        record["speak_text"] = {"samples": int(pcm.shape[0]),
                                "sentences": sentences}
        print(f"book: speak --text {seconds['speak_text']:.1f} s, "
              f"{pcm.shape[0] / mc.sample_rate:.2f} s of audio from 3 "
              f"sentences on the chain's artifact [{card}]")
    torch.cuda.empty_cache()
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"book phase: {seconds['phase']:.1f} s [{card}]")
    return record


# --------------------------------------------------------------------------- #
# interop and the joint stage: a torch reference checkpoint through
# import-torch and speak, train --stage joint --init-torch with converted
# SLM weights, and CLI test


def _launch_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def _counting(make, record: list, kernels):
    """``make`` (``make_train_step`` or ``make_eval_step``) whose steps
    append each call's launches of every kernel to ``record``; the counts
    themselves are not touched."""
    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(*a, **k):
            before = _launch_counts(kernels)
            out = fn(*a, **k)
            record.append({name: n - before[name] for name, n in
                           _launch_counts(kernels).items()})
            return out

        return step

    return wrapped


def _interop_hook(kernels, record: dict, converted: dict, slm_file: dict):
    """The joint run's ``on_stage``: at the start the state's models must
    equal the converted reference (every tensor) and the loop's SLM the
    SLM file, and the state is copied to the host; at the end each model's
    moved tensors are counted against that copy and its parameters
    counted."""
    from stylish_tts_tpu_torch.convert import load_flax_params
    from stylish_tts_tpu_torch.utils.harness import count_params

    def hook(event: str, stage: str, state) -> None:
        torch.cuda.synchronize()
        record["events"].append([event, stage])
        if event == "start":
            n = 0
            for name, (params, stats) in converted.items():
                if name not in state.models:
                    continue
                module = state.models[name]
                want = load_flax_params(name, {**params, **stats}, module)
                for key, t in module.state_dict().items():
                    if not torch.equal(t.cpu(), want[key]):
                        raise AssertionError(f"init-torch: {name}.{key} is "
                                             f"not the converted reference")
                    n += 1
            slm = record["slm"].state_dict()
            if set(slm) != set(slm_file):
                raise AssertionError("the loop's SLM holds other tensors")
            for key, t in slm.items():
                if not torch.equal(t.cpu(), slm_file[key]):
                    raise AssertionError(f"the loop's SLM {key} is not the "
                                         f"file's")
            record["start_equal_tensors"] = n
            record["slm_equal_tensors"] = len(slm)
            record["start"] = {k: {n: t.cpu().clone() for n, t in
                                   m.state_dict().items()}
                               for k, m in state.models.items()}
            return
        if event != "end":
            return
        start = record.pop("start")
        moved = {}
        for key, module in state.models.items():
            params = {n for n, _ in module.named_parameters()}
            now = module.state_dict()
            names = [n for n in now if not torch.equal(now[n].cpu(),
                                                       start[key][n])]
            moved[key] = {"params": sum(n in params for n in names),
                          "buffers": sum(n not in params for n in names)}
        record["moved"] = moved
        record["params"] = {k: count_params(m)
                            for k, m in state.models.items()}

    return hook


def interop_path(device, card: str, kernels, data: Path,
                 acoustic_per_step: dict) -> dict:
    """A reference checkpoint through ``import-torch`` and ``speak``, the
    joint stage of CLI ``train`` from it on phase 7's dataset ``data``, and
    CLI ``test``, at the full-width default ModelConfig; see the module
    docstring, phase 9."""
    import functools
    import io
    import tempfile
    import wave

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, ModelConfig, dump_json
    from stylish_tts_tpu_torch.convert import export_flax_params
    from stylish_tts_tpu_torch.export.import_torch import (
        BATCH_STATS_PREFIX, INFERENCE_MODELS, load_converted_module,
        load_reference_state_dicts)
    from stylish_tts_tpu_torch.export.infer import Synthesizer
    from stylish_tts_tpu_torch.export.package import load_inference_models
    from stylish_tts_tpu_torch.models.torch_convert import (CONVERTERS,
                                                            convert_module)
    from stylish_tts_tpu_torch.scripts.spec_conv_times import \
        LAUNCHES_PER_LAYER
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.train.init import (build_training_models,
                                                  init_params, init_slm)
    from stylish_tts_tpu_torch.train.stages import STAGES
    from stylish_tts_tpu_torch.utils.harness import count_params
    from stylish_tts_tpu_torch.utils.synthetic import \
        write_reference_checkpoint
    from stylish_tts_tpu_torch.utils.tensorfile import (read_safetensors,
                                                        write_safetensors)

    t_phase = time.perf_counter()
    mc = ModelConfig()
    hop = mc.hop_length
    record: dict = {"card": card, "seconds": {}, "events": []}
    seconds = record["seconds"]
    # what a joint step launches: its spectrograms, and the MRD's layers
    per_step = {"stft_forward": STFT_PER_STEP["train"],
                **{f"spec_conv_{name}": n * len(mrd_layers())
                   for name, n in LAUNCHES_PER_LAYER.items()}}
    per_eval = {"stft_forward": STFT_PER_STEP["eval"],
                **{f"spec_conv_{name}": 0 for name in LAUNCHES_PER_LAYER}}
    if per_step != acoustic_per_step:
        raise AssertionError(f"the acoustic step launched "
                             f"{acoustic_per_step}, the derivation gives "
                             f"{per_step}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_interop_") as tmp:
        root = Path(tmp)
        # 1. the reference checkpoint: the chain's models and the aligner
        # from a seed, at the levels synthesis needs
        t0 = time.perf_counter()
        built = build_training_models(mc)
        generator = torch.Generator().manual_seed(40)
        reference = {k: init_params(built[k], generator) for k in CONVERTERS}
        speech_levels(reference)
        ckpt = root / "reference"
        files = write_reference_checkpoint(ckpt, reference,
                                           safetensors=REFERENCE_SAFETENSORS)
        converted = {k: convert_module(k, sd) for k, sd in
                     load_reference_state_dicts(ckpt).items()}
        seconds["reference"] = time.perf_counter() - t0
        record["reference_bytes"] = {k: p.stat().st_size
                                     for k, p in files.items()}
        print(f"interop: reference checkpoint of {len(files)} models "
              f"({', '.join(f'{k} {p.name}' for k, p in files.items())}), "
              f"{sum(record['reference_bytes'].values()):,} bytes, "
              f"{seconds['reference']:.1f} s [{card}]")

        # 2. import-torch, the artifact against the in-process conversion
        art = root / "artifact"
        t0 = time.perf_counter()
        cli.main(["import-torch", "--checkpoint", str(ckpt), "--out",
                  str(art)])
        seconds["import_torch"] = time.perf_counter() - t0
        tensors = 0
        for name in (*INFERENCE_MODELS, "text_aligner"):
            params, stats = converted[name]
            want = {**params, **{BATCH_STATS_PREFIX + k: np.atleast_1d(v)
                                 for k, v in stats.items()}}
            got = read_safetensors(art / f"{name}.safetensors")
            if set(got) != set(want) or any(
                    got[k].dtype != want[k].dtype
                    or not np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError(f"import-torch: {name} differs from "
                                     f"the in-process conversion")
            tensors += len(got)
        amc = json.loads((art / "model_config.json").read_text())
        if amc["pitch_energy_predictor"]["reference_band_mask"] is not True:
            raise AssertionError("the artifact's config lacks the "
                                 "reference band mask")
        record["artifact_bytes"] = sum(p.stat().st_size
                                       for p in art.iterdir())
        record["artifact_tensors"] = tensors
        # speak from the artifact, checked as in phase 4
        text = phoneme_strings(mc.symbol, [80], seed=7)[0]
        wav = root / "speech.wav"
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        cli.main(["speak", "--artifact", str(art), "--phonemes", text,
                  "--out", str(wav)])
        seconds["speak"] = time.perf_counter() - t0
        record["speak_launches"] = _launch_counts(kernels)
        if record["speak_launches"]["stft_forward"] == 0:
            raise AssertionError("speak from the imported artifact never "
                                 "launched the STFT")
        with wave.open(str(wav), "rb") as f:
            frames = f.getnframes()
            pcm = np.frombuffer(f.readframes(frames), "<i2")
        if frames == 0 or frames % hop or not np.abs(pcm).max():
            raise AssertionError(f"speak wrote {frames} samples, max "
                                 f"{np.abs(pcm).max() if frames else 0}")
        smc, models = load_inference_models(art, device)
        audio = Synthesizer(smc, models, device=device,
                            sample_seed=0).synthesize(text, fixed_duration=8)
        check_audio(audio, 80 + 2, 8, hop, "synthesize from the imported "
                                           "artifact")
        del models
        # import-torch --model on the aligner's file
        t0 = time.perf_counter()
        cli.main(["import-torch", "--checkpoint", str(files["text_aligner"]),
                  "--out", str(root / "aligner"), "--model", "text_aligner"])
        seconds["import_torch_model"] = time.perf_counter() - t0
        aligner = load_converted_module(
            root / "aligner" / "text_aligner.safetensors", "text_aligner",
            build_training_models(mc)["text_aligner"])
        want = reference["text_aligner"].state_dict()
        for key, t in aligner.state_dict().items():
            if not torch.equal(t, want[key]):
                raise AssertionError(f"import-torch --model text_aligner: "
                                     f"{key} differs")
        print(f"interop: import-torch {seconds['import_torch']:.1f} s, "
              f"{record['artifact_bytes']:,} bytes, {tensors} tensors equal "
              f"to the in-process conversion, reference band mask on; speak "
              f"80 phonemes {seconds['speak']:.1f} s "
              f"({frames / mc.sample_rate:.2f} s of audio), launches {record['speak_launches']}; import-torch "
              f"--model text_aligner {seconds['import_torch_model']:.1f} s, "
              f"the aligner equal to its source [{card}]")

        # 3. the SLM's weights file at 12 layers, under the flax names
        slm_path = root / "wavlm.safetensors"
        source = init_slm(mc, torch.Generator().manual_seed(41))
        write_safetensors(slm_path, export_flax_params("slm", source))
        slm_file = {k: t.clone() for k, t in source.state_dict().items()}
        del source

        # 4. train --stage joint from the reference, on phase 7's dataset
        cfg = Config()
        cfg.dataset.path = str(data)
        plan = cfg.training_plan.joint
        plan.epochs, plan.probe_batch_max = 1, JOINT_BATCH
        cfg.training.log_interval = 1
        cfg.training.val_interval = cfg.training.save_interval = \
            JOINT_INTERVAL
        cfg.training.aot_memory_plan = False
        jmc = ModelConfig()
        jmc.slm.weights_path = str(slm_path)
        (root / "config.json").write_text(dump_json(cfg))
        (root / "model.json").write_text(dump_json(jmc))
        steps, evals = [], []
        originals = (loop.train_model, loop.make_train_step,
                     loop.make_eval_step, loop.init_slm)

        def capture_slm(*args, **kwargs):
            record["slm"] = originals[3](*args, **kwargs)
            return record["slm"]

        loop.train_model = functools.partial(
            originals[0], on_stage=_interop_hook(kernels, record, converted,
                                                 slm_file))
        loop.make_train_step = _counting(originals[1], steps, kernels)
        loop.make_eval_step = _counting(originals[2], evals, kernels)
        loop.init_slm = capture_slm
        out = root / "out"
        t0 = time.perf_counter()
        try:
            cli.main(["train", "--config", str(root / "config.json"),
                      "--model-config", str(root / "model.json"), "--out",
                      str(out), "--stage", "joint", "--init-torch",
                      str(ckpt), "--max-steps", str(JOINT_STEPS)])
        finally:
            (loop.train_model, loop.make_train_step, loop.make_eval_step,
             loop.init_slm) = originals
        seconds["train_joint"] = time.perf_counter() - t0
        del record["slm"]
        if record["events"] != [["start", "joint"], ["planned", "joint"],
                                ["end", "joint"]]:
            raise AssertionError(f"joint events {record['events']}")
        stage = STAGES["joint"]
        trained = stage.train_models + stage.discriminators
        for key, moved in record["moved"].items():
            if key in trained and not moved["params"]:
                raise AssertionError(f"joint: {key} did not move")
            if key not in trained and (moved["params"] or moved["buffers"]):
                raise AssertionError(f"joint: {key} changed: {moved}")
        if not {"pe_mel_style_encoder", "duration_predictor"} <= set(
                record["moved"]):
            raise AssertionError("the joint state lacks a model")
        stats = json.loads((out / "joint" / "train_stats.json").read_text())
        man = json.loads((out / "joint" / "checkpoint_final" / "meta.json")
                         .read_text())["manifest"]
        if (man["stage"], man["current_total_step"], stats["steps"]) != (
                "joint", JOINT_STEPS, JOINT_STEPS):
            raise AssertionError(f"joint manifest {man}, {stats['steps']} "
                                 f"steps")
        names = {"mel", "slm", "mag", "phase", "style", "pitch", "energy",
                 "generator", "discriminator"}
        values = [e["loss"] for e in stats["logs"]] + [
            v["loss"] for v in stats["validations"]] + [
            m for v in stats["validations"] for m in v["metrics"].values()]
        for entry in stats["logs"]:
            if set(entry["metrics"]) != names:
                raise AssertionError(f"joint metrics {entry['metrics']}")
            values += list(entry["metrics"].values())
        if not stats["validations"] or not all(np.isfinite(values)):
            raise AssertionError("joint: non-finite metrics or no "
                                 "validation")
        if stats["guard"]["oom"] or len(steps) != JOINT_STEPS:
            raise AssertionError(f"joint: {len(steps)} steps, "
                                 f"{stats['guard']['oom']} OOM")
        for i, got in enumerate(steps):
            if got != per_step:
                raise AssertionError(f"joint step {i} launched {got}, its "
                                     f"spectrograms and the MRD give "
                                     f"{per_step}")
        for i, got in enumerate(evals):
            if got != per_eval:
                raise AssertionError(f"joint eval batch {i} launched {got}, "
                                     f"want {per_eval}")
        record["launches_per_step"] = per_step
        record["eval_batches"] = len(evals)
        shapes, first, warm = set(), [], []
        for entry, (_, *shape) in zip(stats["logs"], stats["batches"]):
            (warm if tuple(shape) in shapes else first).append(
                round(entry["seconds"] * 1e3))
            shapes.add(tuple(shape))
        record["step_ms"] = {"first_visit": first, "warm": warm}
        record["stats"] = stats
        print(f"interop: train --stage joint --init-torch "
              f"{seconds['train_joint']:.1f} s for {stats['steps']} steps "
              f"{stats['batches']}, wall ms first visit {first}, warm "
              f"{warm or 'none'}; {record['start_equal_tensors']} tensors "
              f"equal to the converted reference and the SLM's "
              f"{record['slm_equal_tensors']} to its file at the start; "
              f"validation "
              f"{[round(v['seconds'], 2) for v in stats['validations']]} s "
              f"({len(evals)} eval batches, each {per_eval}), saves "
              f"{[round(v['seconds'], 2) for v in stats['saves']]} s; every "
              f"step launched {per_step} [{card}]")
        batch_shapes = sorted({(rows, samples) for _, rows, _, samples in
                               stats["batches"]})
    torch.cuda.empty_cache()
    record["batch_shape_checks"] = batch_shape_checks(batch_shapes, card)

    # 5. CLI test at its defaults
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["test"])
    seconds["test"] = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    rows = {}
    for line in lines[1:-1]:
        name, count = line.split()
        rows[name] = int(count.replace(",", ""))
    counts = dict(record["params"], text_aligner=count_params(aligner))
    # the experimental stages' models, which the joint state does not hold
    extra = [name for name in rows if name not in counts and name != "TOTAL"]
    counts.update({name: count_params(m) for name, m in
                   build_training_models(mc, extra).items()})
    total = rows.pop("TOTAL")
    if total != sum(rows.values()) or any(
            n != counts[name] for name, n in rows.items()):
        raise AssertionError(f"test's table {rows}, the state's {counts}")
    stft_launches = _launch_counts(kernels)["stft_forward"]
    if stft_launches != 10 + 1:  # --iters 10 and the warm-up
        raise AssertionError(f"test's forward launched the STFT "
                             f"{stft_launches} times in 11 calls")
    forward = lines[-1]
    ms = float(forward.split(": ")[1].split(" ms")[0])
    rtf = float(forward.split("(")[1].split("x")[0])
    record["test"] = {"rows": rows, "ms_per_batch": ms, "x_real_time": rtf,
                      "stft_launches": stft_launches}
    print(f"interop: CLI test {seconds['test']:.1f} s, {len(rows)} rows "
          f"equal to the state's modules ({total:,} parameters); "
          f"{forward}; the STFT launched {stft_launches} times in 11 "
          f"forwards [{card}]")
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"interop phase: {seconds['phase']:.1f} s [{card}]")
    return record


# --------------------------------------------------------------------------- #
# the experimental stages: hubert_acoustic, cfm_hubert_pitch and
# cfm_hubert_mel through CLI train on their frozen nets' weight files


def write_frozen_nets(root: Path, seed: int) -> dict:
    """Seeded full-width frozen nets written as flat safetensors of their
    flax names, the files ``hubert.weights_path``,
    ``speaker_embedder.weights_path`` and ``training.vocos_weights`` read:
    the HuBERT-base encoder (6 layers, 768 wide), the SimAM-ResNet34 (64
    channels, 10240-d statistics) and Vocos (512 wide, 8 blocks, layer
    scale 1/8).  Returns {name: (path, {torch key: tensor})}."""
    from stylish_tts_tpu_torch.convert import export_flax_params
    from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu_torch.models.vocos import Vocos
    from stylish_tts_tpu_torch.models.wespeaker import SimAMResNet34ASP
    from stylish_tts_tpu_torch.train.init import init_params
    from stylish_tts_tpu_torch.utils.tensorfile import write_safetensors

    gen = torch.Generator().manual_seed(seed)
    nets = {"hubert": SLMFeatureExtractor(n_layers=6, rel_pos_bias=False),
            "speaker": SimAMResNet34ASP(), "vocos": Vocos()}
    files = {}
    for name, module in nets.items():
        init_params(module, gen)
        if name == "vocos":
            for block in module.modules():
                if hasattr(block, "gamma"):
                    block.gamma.data.fill_(1.0 / module.n_layers)
        path = root / f"{name}.safetensors"
        write_safetensors(path, export_flax_params(name, module))
        files[name] = (path, {k: t.clone() for k, t in
                              module.state_dict().items()})
    return files


def _experimental_hook(kernels, record: dict, files: dict, nets: dict,
                       device):
    """The run's ``on_stage``: at the start the frozen nets the loop built
    (``nets``) must equal their files, tensor for tensor, the launch
    counts go to 0 and the models are copied to the host; at the end each
    model's moved tensors are listed against that copy."""
    def hook(event: str, stage: str, state) -> None:
        torch.cuda.synchronize()
        record["events"].append([event, stage])
        if event == "start":
            n = 0
            parts = [("hubert", nets["ssl"][0].encoder),
                     ("speaker", nets["ssl"][1].xvector)]
            if nets.get("vocos") is not None:
                parts.append(("vocos", nets["vocos"]))
            for name, module in parts:
                want = files[name][1]
                got = module.state_dict()
                if set(got) != set(want):
                    raise AssertionError(f"{stage}: the {name} net holds "
                                         f"other tensors than its file")
                for key, t in got.items():
                    if t.device.type != torch.device(device).type or \
                            not torch.equal(t.cpu(), want[key]):
                        raise AssertionError(f"{stage}: {name}.{key} is not "
                                             f"its file's on {device}")
                    n += 1
            record["frozen_equal_tensors"] = n
            for k in kernels:
                k.launches = 0
            record["start"] = {k: {n: t.cpu().clone() for n, t in
                                   m.state_dict().items()}
                               for k, m in state.models.items()}
            return
        if event != "end":
            return
        record["launches"] = _launch_counts(kernels)
        start = record["start"]
        moved = {}
        for key, module in state.models.items():
            now = module.state_dict()
            moved[key] = [n for n in now if not torch.equal(now[n].cpu(),
                                                            start[key][n])]
        record["moved"] = moved
        record["end_state"] = {n: t.cpu().clone() for n, t in
                               state.models["hubert_encoder"]
                               .state_dict().items()}

    return hook


def _recording(make, record: list, kernels):
    """``make`` (``make_train_step`` or ``make_eval_step``) whose steps
    append each call's kernel launches, wall ms, batch shape and, for an
    eval step's audio, its shape, peak and finiteness to ``record``."""
    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(state, batch, *a, **k):
            before = _launch_counts(kernels)
            t0 = time.perf_counter()
            out = fn(state, batch, *a, **k)
            torch.cuda.synchronize()
            entry = {"ms": (time.perf_counter() - t0) * 1e3,
                     "shape": list(batch["audio_gt"].shape),
                     "launches": {n: c - before[n] for n, c in
                                  _launch_counts(kernels).items()}}
            audio = out[1] if isinstance(out[1], torch.Tensor) else None
            if audio is not None:
                entry["audio"] = {"shape": list(audio.shape),
                                  "max_abs": float(audio.abs().max()),
                                  "finite": bool(torch.isfinite(audio)
                                                 .all())}
            record.append(entry)
            return out

        return step

    return wrapped


def experimental_path(device, card: str, kernels, data: Path) -> dict:
    """The experimental stages at the full-width default ModelConfig on
    phase 7's dataset ``data``, each through CLI ``train`` on seeded weight
    files of its frozen nets; see the module docstring, phase 10."""
    import functools
    import tempfile

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, ModelConfig, dump_json
    from stylish_tts_tpu_torch.models.vocos import VOCOS_HOP, VOCOS_N_FFT
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.train.optim import (WEIGHT_DECAY,
                                                   cosine_logical_lr)
    from stylish_tts_tpu_torch.train.stages import STAGES

    t_phase = time.perf_counter()
    record: dict = {"card": card, "runs": {}}
    mc0 = ModelConfig()
    hop = mc0.hop_length
    per_layer = {f"spec_conv_{name}": n * len(mrd_layers())
                 for name, n in LAUNCHES_PER_LAYER.items()}
    shapes = {run: set() for run, *_ in EXPERIMENTAL_RUNS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_experimental_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        files = write_frozen_nets(root, seed=50)
        record["weights_s"] = time.perf_counter() - t0
        record["weight_bytes"] = {k: p.stat().st_size
                                  for k, (p, _) in files.items()}
        print(f"experimental: seeded frozen nets written "
              f"{json.dumps(record['weight_bytes'])} bytes in "
              f"{record['weights_s']:.1f} s [{card}]")
        for run, stage, features, steps in EXPERIMENTAL_RUNS:
            mc = ModelConfig()
            mc.hubert.weights_path = str(files["hubert"][0])
            mc.speaker_embedder.weights_path = str(files["speaker"][0])
            mc.cfm_mel_features = features
            cfg = Config()
            cfg.dataset.path = str(data)
            plan = getattr(cfg.training_plan, stage)
            plan.epochs, plan.probe_batch_max = 1, EXPERIMENTAL_BATCH
            if stage == "cfm_hubert_mel":
                plan.lr = EXPERIMENTAL_MEL_LR
            cfg.training.log_interval = 1
            cfg.training.val_interval = steps
            cfg.training.save_interval = 10 ** 6
            cfg.training.aot_memory_plan = False
            if features == "vocos":
                cfg.training.vocos_weights = str(files["vocos"][0])
            (root / "config.json").write_text(dump_json(cfg))
            (root / "model.json").write_text(dump_json(mc))
            out = root / f"out_{run}"
            rec: dict = {"events": []}
            nets: dict = {}
            train_calls, eval_calls = [], []
            originals = (loop.train_model, loop.make_train_step,
                         loop.make_eval_step, loop.init_ssl, loop.init_vocos)

            def capture_ssl(*a, **k):
                nets["ssl"] = originals[3](*a, **k)
                return nets["ssl"]

            def capture_vocos(*a, **k):
                nets["vocos"] = originals[4](*a, **k)
                return nets["vocos"]

            loop.train_model = functools.partial(
                originals[0], on_stage=_experimental_hook(
                    kernels, rec, files, nets, device))
            loop.make_train_step = _recording(originals[1], train_calls,
                                              kernels)
            loop.make_eval_step = _recording(originals[2], eval_calls,
                                             kernels)
            loop.init_ssl, loop.init_vocos = capture_ssl, capture_vocos
            t0 = time.perf_counter()
            try:
                cli.main(["train", "--config", str(root / "config.json"),
                          "--model-config", str(root / "model.json"),
                          "--out", str(out), "--stage", stage,
                          "--max-steps", str(steps)])
            finally:
                (loop.train_model, loop.make_train_step, loop.make_eval_step,
                 loop.init_ssl, loop.init_vocos) = originals
            rec["seconds"] = time.perf_counter() - t0
            nets.clear()

            # the run's stage, checkpoint, metrics and validation
            if rec["events"] != [["start", stage], ["planned", stage],
                                 ["end", stage]]:
                raise AssertionError(f"{run}: events {rec['events']}")
            stats = json.loads((out / stage / "train_stats.json")
                               .read_text())
            man = json.loads((out / stage / "checkpoint_final" / "meta.json")
                             .read_text())["manifest"]
            if (man["stage"], man["current_step"], stats["steps"],
                    len(train_calls)) != (stage, steps, steps, steps):
                raise AssertionError(f"{run}: manifest {man}, "
                                     f"{stats['steps']} steps")
            saved = sorted(p.stem for p in (out / stage / "checkpoint_final"
                                            / "models").iterdir())
            if saved != sorted(loop.EXPERIMENTAL_MODELS):
                raise AssertionError(f"{run}: checkpoint holds {saved}")
            values = [e["loss"] for e in stats["logs"]] + [
                v for e in stats["logs"] for v in e["metrics"].values()] + [
                v["loss"] for v in stats["validations"]] + [
                m for v in stats["validations"]
                for m in v["metrics"].values()]
            if len(stats["validations"]) != 1 or not all(np.isfinite(values)):
                raise AssertionError(f"{run}: validations "
                                     f"{stats['validations']}, non-finite "
                                     f"metrics or none")
            # the models: trained ones moved, the hubert encoder by the
            # decay alone, the rest bit-equal
            st = STAGES[stage]
            trained = st.train_models + st.discriminators
            for key, names in rec["moved"].items():
                if key == "hubert_encoder" and stage == "cfm_hubert_mel":
                    continue
                if key in trained and not names:
                    raise AssertionError(f"{run}: {key} did not move")
                if key not in trained and names:
                    raise AssertionError(f"{run}: {key} changed: "
                                         f"{names[:4]}")
            if stage == "cfm_hubert_mel":
                limit = max(man["steps_per_epoch"] * plan.epochs, 1)
                start = rec["start"]["hubert_encoder"]
                decayed = 0
                for name, t in rec["end_state"].items():
                    want = start[name].to(device)
                    for i in range(steps):
                        want = want.mul(1 - cosine_logical_lr(
                            plan.lr, i, limit) * WEIGHT_DECAY)
                    if not torch.equal(t, want.cpu()):
                        raise AssertionError(f"{run}: hubert_encoder.{name} "
                                             f"moved by more than the decay")
                    decayed += not torch.equal(t, start[name])
                if not decayed:
                    raise AssertionError(f"{run}: the decay moved nothing")
                rec["hubert_encoder_decayed"] = decayed
            # the launches: every train step and eval batch as its
            # spectrograms (and the MRD's layers) give
            stft = EXPERIMENTAL_STFT[run]
            want_train = {"stft_forward": stft["train"], **{
                k: (n if "mrd" in st.discriminators else 0)
                for k, n in per_layer.items()}}
            want_eval = {"stft_forward": stft["eval"],
                         **{k: 0 for k in per_layer}}
            for i, call in enumerate(train_calls):
                if call["launches"] != want_train:
                    raise AssertionError(f"{run} step {i} launched "
                                         f"{call['launches']}, want "
                                         f"{want_train}")
            if not eval_calls:
                raise AssertionError(f"{run}: no eval batch")
            for i, call in enumerate(eval_calls):
                if call["launches"] != want_eval:
                    raise AssertionError(f"{run} eval batch {i} launched "
                                         f"{call['launches']}, want "
                                         f"{want_eval}")
                audio = call.get("audio")
                samples = call["shape"][1]
                if stage == "cfm_hubert_pitch":
                    if audio is not None:
                        raise AssertionError(f"{run}: eval audio")
                    continue
                if features == "vocos":
                    length = samples // VOCOS_HOP * VOCOS_HOP
                else:
                    frames = samples // hop + 1
                    length = (frames - frames % 2) * hop
                if audio is None or audio["shape"] != [call["shape"][0],
                                                       length] \
                        or not audio["finite"] or not audio["max_abs"] > 0:
                    raise AssertionError(f"{run}: eval audio {audio}, want "
                                         f"{length} samples")
            for call in train_calls + eval_calls:
                shapes[run].add(tuple(call["shape"]))
            seen, first, warm = set(), [], []
            for call in train_calls:
                key = tuple(call["shape"])
                (warm if key in seen else first).append(round(call["ms"]))
                seen.add(key)
            rec.update(stats=stats, per_step=want_train, per_eval=want_eval,
                       step_ms={"first_visit": first, "warm": warm},
                       eval_ms=[round(c["ms"]) for c in eval_calls],
                       eval_audio=[c.get("audio") for c in eval_calls],
                       batches=stats["batches"])
            for key in ("start", "end_state", "moved"):
                rec.pop(key)
            record["runs"][run] = rec
            print(f"experimental {run}: CLI train {rec['seconds']:.1f} s for "
                  f"{steps} steps {stats['batches']}, wall ms first visit "
                  f"{first}, warm {warm or 'none'}; validation "
                  f"{rec['eval_ms']} ms over {len(eval_calls)} batches, "
                  f"save {[round(v['seconds'], 2) for v in stats['saves']]}"
                  f" s; {rec['frozen_equal_tensors']} frozen-net tensors "
                  f"equal to their files; every step launched {want_train}, "
                  f"every eval batch {want_eval}"
                  + (f"; the hubert encoder moved by the decay alone "
                     f"({rec['hubert_encoder_decayed']} tensors)"
                     if stage == "cfm_hubert_mel" else "") + f" [{card}]")
    torch.cuda.empty_cache()
    # kernels #1-3 against their plain versions at every batch shape the
    # runs took: the STFT at its five settings and the spec-conv kernels at
    # the MRD's layers where hubert_acoustic ran, the STFT at Vocos's
    # setting where the Vocos run did
    record["batch_shape_checks"] = batch_shape_checks(
        sorted(shapes["hubert_acoustic"]), card)
    others = sorted(set().union(*shapes.values()))
    record["stft_shape_checks"] = []
    for s in others:
        x = torch.randn(*s, device=device, generator=torch.Generator(
            device=device).manual_seed(s[1]))
        settings = [(2048, 300, 1200)] + (
            [VOCOS_STFT] if s in shapes["cfm_hubert_mel_vocos"] else [])
        record["stft_shape_checks"].append({
            "shape": list(s), "settings": settings,
            "max_abs_err": max(stft_error(x, *st)[2] for st in settings)})
    del x
    big = max(shapes["cfm_hubert_mel_vocos"])
    x = torch.randn(*big, device=device,
                    generator=torch.Generator(device=device).manual_seed(7))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    record["stft_vocos"] = stft_numbers(x, *VOCOS_STFT, flush)
    del x, flush
    print(f"experimental: the STFT held at the mel's setting at "
          f"{len(others)} batch shapes {others} and at Vocos's setting "
          f"n_fft={VOCOS_N_FFT} hop={VOCOS_HOP} win={VOCOS_N_FFT} at the "
          f"Vocos run's (max err "
          f"{max(r['max_abs_err'] for r in record['stft_shape_checks']):.2e})"
          f", timed there at {record['stft_vocos']['shape']}: "
          f"{stft_line(record['stft_vocos'])} [{card}]")
    record["cpu_vs_card"] = cpu_vs_card_hubert_step(card)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"experimental phase: {record['seconds']:.1f} s [{card}]")
    return record


def cpu_vs_card_hubert_step(card: str) -> dict:
    """One f32 ``hubert_acoustic`` step at full width on 1 x 64 frames from
    the same weights and frozen nets on the CPU (plain versions) and on the
    card (kernels), dropout off, latent means and the same prior noise;
    the metrics compared under STEP_TOL as phase 5 does."""
    import copy

    from stylish_tts_tpu_torch.config import Config, ModelConfig
    from stylish_tts_tpu_torch.models.norms import Dropout
    from stylish_tts_tpu_torch.train.init import (build_train_state,
                                                  init_params, init_slm,
                                                  init_ssl)
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)

    mc = ModelConfig()
    cfg = Config()
    cfg.training.mixed_precision = "no"
    stage = STAGES["hubert_acoustic"]
    keys = stage.train_models + stage.discriminators
    from stylish_tts_tpu_torch.train.init import build_training_models

    gen = torch.Generator().manual_seed(60)
    built = build_training_models(mc, keys)
    models = {k: init_params(built[k], gen) for k in keys}
    for model in models.values():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    ssl = init_ssl(mc, torch.Generator().manual_seed(61))
    slm = init_slm(mc, torch.Generator().manual_seed(62))
    batch = synthetic_batch(mc, 1, 64, 63)
    noise = np.random.default_rng(64).standard_normal(
        (1, 64 * mc.hop_length)).astype(np.float32)
    # a harmonic prior both devices compute to the ulp: F0 on the
    # 24000/512 Hz grid (every partial sum of the phase integral exact),
    # unvoiced for 3 frames with no prior noise and a silent ground truth
    # under STFT frame 0, which is real, its phase the sign of a rounding
    # (tests/test_torch_port_helpers.py:well_posed_prior_inputs); the
    # speaker vector's style moves the generator's spectra further than
    # the text style of phase 5's step does, and a voiced onset left the
    # card's mel 2.3e-3 from the CPU's
    step_hz = mc.sample_rate / 512
    pitch = np.clip(np.round(batch["pitch"] / step_hz), 2, 6) * step_hz
    pitch[:, :3] = 0.0
    batch["pitch"] = pitch.astype(np.float32)
    noise[:, :(3 * 4 - 2) * (mc.hop_length // 4)] = 0.0
    batch["audio_gt"][:, :mc.n_fft // 2 + 1] = 0.0
    results = {}
    for device in ("cpu", "cuda"):
        state = build_train_state(mc, keys, models=copy.deepcopy(models),
                                  device=device)
        ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                           mel_std=4.0, step_limit=10_000,
                           slm=copy.deepcopy(slm).to(device),
                           ssl=tuple(copy.deepcopy(m).to(device)
                                     for m in ssl))
        _, metrics = make_train_step("hubert_acoustic", ctx, 1e-4)(
            state, on_device(batch, device), sample=False,
            pcph_noise=torch.from_numpy(noise).to(device),
            pcph_phase=torch.zeros(1, 1, device=device))
        results[device] = {k: v.item() for k, v in metrics.items()}
        del state, ctx
    rel = {}
    for key, bound in STEP_TOL.items():
        a, b = results["cpu"][key], results["cuda"][key]
        rel[key] = abs(a - b) / max(abs(a), 1e-30)
        if not rel[key] <= bound:
            raise AssertionError(f"hubert_acoustic step cpu vs card {key}: "
                                 f"{a} vs {b}")
    print(f"full-width hubert_acoustic step f32 on 1 x 64 frames, cpu vs "
          f"card: relative differences {json.dumps(rel)} [{card}]")
    return {"metrics": results, "relative_difference": rel}


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
    import tempfile

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

    # 7. the training chain through CLI train, then convert and speak; 8.
    # from a book's text to a voice, speak --text on the chain's artifact
    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifact_") as keep:
        artifact, data = Path(keep) / "chain_artifact", Path(keep) / "data"
        record["chain"] = chain_path(device, card, kernels, artifact, data)
        record["book"] = book_path(card, kernels, artifact)
        # 9. interop and the joint stage: import-torch, train --stage joint
        # --init-torch on phase 7's dataset, CLI test
        record["interop"] = interop_path(device, card, kernels, data,
                                         train["launches_per_step"])
        # 10. the experimental stages on phase 7's dataset, each through
        # CLI train on seeded weight files of its frozen nets
        record["experimental"] = experimental_path(device, card, kernels,
                                                   data)

    # 11. results: each kernel's own numbers and its launches on the path
    # that runs it: per train step (acoustic, and joint and the
    # experimental runs beside it), or per probe run
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    numbers = {"stft_forward": train_stft, **record["probes"]}
    for name in ("forward", "dgrad", "wgrad"):
        numbers[f"spec_conv_{name}"] = record["spec_conv"]["res0 conv_1"][name]
    launches = {k: (n, "train step")
                for k, n in train["launches_per_step"].items()}
    joint = record["interop"]["launches_per_step"]
    experimental = {run: r["per_step"] for run, r in
                    record["experimental"]["runs"].items()}
    launches.update({k: (n, "probe run")
                     for k, n in record["probe_run"]["launches"].items()})
    entries = []
    for k in [*kernels, *pp.KERNELS]:
        n = numbers[k.name]
        count, per = launches[k.name]
        entries.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": count, "per": per,
            "joint_launches": joint.get(k.name),  # per joint train step
            # per train step of each experimental run
            "experimental_launches": {run: n.get(k.name) for run, n in
                                      experimental.items()},
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

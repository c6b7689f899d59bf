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
   silent, exactly total_frames * hop samples); then two
   ``synthesize_batch_async`` batches (the halves of the 8) dispatched
   back to back before either is read, the counts set to 0 before and
   read after (one STFT launch a batch), no synchronizing operation seen
   in the dispatches (torch's sync debug mode), each bit-equal to
   ``synthesize_batch`` from the same generator state; the STFT kernel is held
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
   weights and their metrics are compared; last the bf16 step at b8 x f460
   four times from the same weights, batch and generator, with
   ``remat_flow`` off, on, on, off (the flow's couplings and the
   posterior WaveNet checkpointed), 1 warm-up and REMAT_TIMED timed steps
   each under deterministic algorithms: each run's peak allocated memory,
   the memory allocated when the speech predictor's forward returns, warm
   wall ms and launches (counts set to 0 before its first step, read after
   its last; equal in every run) printed, the metrics bit-equal at every
   step and the trained parameters within REMAT_PARAM_TOL;
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
   on the card, its metrics within STEP_TOL, on a well-posed prior (F0 on
   the 24000/512 Hz grid, an unvoiced onset); then a diagnostic pass of
   the voiced-onset input (the batch as drawn) on both devices, which
   prints the largest gap at each stage's output (the frozen features, the
   PCPH prior, its STFT, the generator's input, log-magnitude and phase,
   the audio and the mel the loss reads) and asserts nothing.  Each run's seconds and each
   step's wall ms (first visit of its shape, or warm) printed;
11. the ringformer head, data parallelism and the MPD, at the full-width
   default ModelConfig with ``generator: {type: ringformer}`` (decoder
   512, conformer depth 2, upsampling 4 x 5, iSTFT 60/15) on phase 7's
   dataset: first the STFT kernel's DFT path at the head's 60/15/60 on
   [8, 138000], held against its plain version and torch.stft and timed
   beside them and its bound; then CLI ``train --stage acoustic`` through
   the CLI's ``main`` for RING_STEPS steps (batches of up to RING_BATCH,
   the heuristic plan) with a validation at the last, a hook at the
   stage's start setting the launch counts (the STFT's launches at each
   n_fft too) to 0.  Checked: every trained model and the MRD moved, the
   conformers' batch-norm running stats moved, finite metrics and
   validation losses, the validation audio finite, not silent and F x 300
   samples long, every step and eval batch launched the STFT (at n_fft 60:
   its DFT path) and the spec-conv kernels as RING_STFT and the MRD's 12
   layers give.  The same run again with ``--distributed``, a world of one
   on NCCL joined from torchrun's environment (a free port), both runs
   under deterministic algorithms (cuDNN's and torch's deterministic
   mode; the ops torch warns of printed): the same batches, every step's
   metrics, every model's weights and its batch stats equal to the first
   run's (RING_RUN_TOL); the
   collectives a step counted and one NCCL all-reduce of each trained
   module's gradient bucket timed.  The head's log-amplitude conv is at a
   trained model's level in both runs (RING_POST_SCALE).  Then the STFT (both paths) and the
   spec-conv kernels held against their plain versions at every batch
   shape the runs took; one f32 ringformer step at full width on 1 x 64
   frames on the CPU and on the card within STEP_TOL; last the MPD: a
   seeded reference state dict through CLI ``import-torch --model mpd``
   (every tensor of the loaded MPD equal to its source), its forward and
   backward at [8, 138000] f32 on the card timed, and held against the
   CPU at MPD_CPU_SHAPE within MPD_TOL.  Each run's seconds and each
   step's wall ms printed;
12. RMVPE pitch and the conversion scripts, on phase 8's book dataset: a
   seeded full-width RMVPE (its batch norms away from the identity) as the
   reference's state dict through ``scripts/convert_rmvpe.py``, loaded on
   the card (every tensor its source); CLI ``pitch --method rmvpe
   --rmvpe-weights`` through the CLI's ``main``, the launch counts set to
   0 just before and read just after: a finite track of samples // hop + 1
   frames a segment, f0 >= 0, one STFT launch a segment at n_fft 1024 (hop
   160, window 1024, B = 1) and no other kernel; the STFT held against its
   plain version and torch.stft at every length the run took and timed at
   the longest beside its bound; one segment's salience on the card
   against the CPU within RMVPE_CPU_TOL (f32, TF32 off); last the five
   conversion scripts on seeded full-width inputs (the SSL encoders as
   local HF checkpoint directories written through ``tensorfile``), each
   file equal to the in-process conversion.  The seconds a segment
   printed;
13. the root tools: ``scripts/pitch_eval.py``'s YIN, raw and refined, on
   TOOLS_UTTS speech-like utterances on the card and on the CPU (tracks
   within YIN_F0_REL and YIN_VOICING of each other, the cents figures
   within PITCH_CENTS_TOL), both reports printed; ``scripts/g2p_eval.py``'s
   report (host), which must equal the committed ``G2P_r05.json``; and
   ``scripts/train_homographs.py`` at its default 200 epochs into a
   temporary file (host), its report printed with whether its w, b and
   alpha equal the committed ``textfrontend/data/homograph_lr.npz``'s;
14. one JSON line of every kernel's numbers, with its launches on the path
   that runs it (per train step, acoustic, joint, each experimental run,
   the remat_flow step and the ringformer step, synthesis request or
   probe run; the STFT's DFT path an entry of its own, per ringformer
   step, and its RMVPE shape one too, per file), then the result line.

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
# phase 5's step with remat_flow off and on, under deterministic
# algorithms: timed steps after one warm-up, and the bound on the updated
# parameters' gap (of each tensor's largest value; the same ops on the same
# inputs, so 0 is expected)
REMAT_TIMED, REMAT_PARAM_TOL = 2, 1e-6
# the tools' phase: pitch_eval's utterances, and its YIN on the card
# against the CPU: tracks at the port-against-JAX bounds of
# tests/test_torch_port_dataprep.py, cents figures within PITCH_CENTS_TOL
TOOLS_UTTS, PITCH_CENTS_TOL, YIN_F0_REL, YIN_VOICING = 4, 0.1, 5e-3, 0.99
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
# its models: the chain's, the aligner and the discriminators (the
# experimental models and the frozen nets convert in phase 12's scripts
# and the CPU tests)
REFERENCE_MODELS = ("mrd", "mpd", "text_aligner", "duration_predictor",
                    "pitch_energy_predictor", "speech_predictor",
                    "pe_text_encoder", "pe_text_style_encoder",
                    "pe_mel_style_encoder")
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
# the ringformer phase on phase 7's dataset: CLI train of the acoustic
# stage with the ringformer head for RING_STEPS steps of batches of up to
# RING_BATCH (the heuristic plan), a validation at the last; the head's
# iSTFT grid (n_fft = win, hop), served by the STFT's DFT path.  STFT
# launches of its train step: the mel, the 6 spectrograms and the
# posterior encoder's input (at hop 300), the source's and the magphase
# target's at RING_N_FFT; of its eval batch: the mel, the 6 spectrograms
# and the source
RING_STEPS, RING_BATCH = 4, 8
RING_N_FFT, RING_HOP = 60, 15
RING_STFT = {"train": {"all": 1 + 2 * 3 + 1 + 2, "dft": 2},
             "eval": {"all": 1 + 2 * 3 + 1, "dft": 1}}
# the distributed run against the plain one, both under
# deterministic_algorithms: every step's metrics and the final weights and
# batch stats (relative to each model's largest) within RING_RUN_TOL, that
# is equal: a world of one adds only exact operations (a sum over one
# rank, a division by 1).  Without deterministic algorithms two plain runs
# of these bf16 steps differ by up to 3.7e-3 at step 4 (mel), as cuDNN's
# algorithms accumulate in no fixed order
RING_RUN_TOL = 0.0
# the RMVPE phase on phase 8's book dataset: the seeded weights' seed, the
# bound on one segment's salience on the card against the CPU (f32, TF32
# off), and the positional conv's fold (g * v / |v|) of the SSL scripts
RMVPE_SEED, RMVPE_CPU_TOL, SSL_FOLD_REL = 12, 1e-3, 1e-6
# the leaves of the batch-stats collections: batch norms' running moments
# and spectral norms' vectors
BATCH_STATS = ("mean", "var", "u", "sigma")
# the head's conv_post weights at a trained model's level, as phase 4
# sets synthesis's heads: drawn at full width, exp(logamp) reaches 1e4 and
# the GAN losses 1e9-1e12 (measured on an H100)
RING_POST_SCALE = 0.05
# the MPD's forward and backward on the card at the train step's audio,
# and on the CPU and the card at a cut (the CPU's f32 convs at 1024
# channels would take minutes at the full shape); relative bound between
# them (f32 convs summed in another order, TF32 off)
MPD_SHAPE, MPD_CPU_SHAPE, MPD_TOL = (8, 138000), (1, 12000), 1e-3


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


def stft_vs_torch(x: torch.Tensor, real: torch.Tensor, imag: torch.Tensor,
                  n_fft: int, hop: int, win: int) -> float:
    """The kernel's (real, imag) of ``x`` against an independent algorithm,
    cuFFT through torch.stft: the max error, which must stay within
    KERNEL_TOL of the largest value."""
    from stylish_tts_tpu_torch.ops import stft as plain

    window = plain._padded_window(win, n_fft).to(x.device)
    lib = torch.stft(x, n_fft, hop, n_fft, window, center=True,
                     pad_mode="reflect", return_complex=True).transpose(1, 2)
    lib_err = max((real - lib.real).abs().max().item(),
                  (imag - lib.imag).abs().max().item())
    if not lib_err <= KERNEL_TOL * lib.abs().max().item():
        raise AssertionError(f"stft n_fft={n_fft} hop={hop}: kernel vs "
                             f"torch.stft max err {lib_err:.3e}")
    return lib_err


def stft_numbers(x: torch.Tensor, n_fft: int, hop: int, win: int,
                 flush: torch.Tensor) -> dict:
    """Hold the kernel against the plain version on ``x`` and time both,
    torch.stft, and the bound."""
    from stylish_tts_tpu_torch.ops import stft as plain
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    real, imag, err = stft_error(x, n_fft, hop, win)
    lib_err = stft_vs_torch(x, real, imag, n_fft, hop, win)
    window = plain._padded_window(win, n_fft).to(x.device)
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

    # the least the card could take for this function, whichever path
    # computes it: a real FFT of n_fft points per frame, about 2.5 * n_fft
    # * log2(n_fft) FLOP (half a complex radix-2 FFT's 5 N log2 N), plus
    # the window's n_fft products (the DFT path's 4 n_fft a (frame, bin)
    # is more work than the function needs); bytes are the signal and the
    # window read once and (real, imag) written once
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


def remat_path(device, card: str, kernels) -> dict:
    """Phase 5's step at b8 x f460, bf16, run four times from the same
    weights, batch and generator, with ``remat_flow`` off, on, on, off
    (so neither setting always runs first), each 1 warm-up and REMAT_TIMED
    timed steps under deterministic algorithms.  Per run: the peak
    allocated memory over the timed steps, the memory allocated when the
    speech predictor's forward returns (its kept activations, the flow's
    among them, are all live there), the timed steps' wall ms and the
    kernels' launches (counts set to 0 before the warm-up, read after the
    last step).  Every run's metrics must be bit-equal to the first's at
    every step, and its trained models' parameters within REMAT_PARAM_TOL
    of each tensor's largest value (bit-equal expected)."""
    from stylish_tts_tpu_torch.config import Config, ModelConfig
    from stylish_tts_tpu_torch.train.stages import STAGES

    t_phase = time.perf_counter()
    trained = STAGES["acoustic"].train_models + ["mrd"]
    runs = []
    with deterministic_algorithms() as warned:
        for remat in (False, True, True, False):
            mc = ModelConfig()
            mc.remat_flow = remat
            state, step = train_setup(mc, Config(), device, seed=10)
            predictor = state.models["speech_predictor"]
            if predictor.flow.remat is not remat:
                raise AssertionError("remat_flow did not reach the flow")
            after_forward = []
            hook = predictor.register_forward_hook(
                lambda *_: after_forward.append(
                    torch.cuda.memory_allocated()))
            batch = on_device(synthetic_batch(mc, TRAIN_BATCH, TRAIN_FRAMES,
                                              11), device)
            gen = torch.Generator(device=device).manual_seed(12)
            for k in kernels:
                k.launches = 0
            metrics = [step(state, batch, gen)[1]]  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(REMAT_TIMED):
                t0 = time.perf_counter()
                metrics.append(step(state, batch, gen)[1])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            hook.remove()
            runs.append({
                "remat": remat,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "after_forward_bytes": max(after_forward),
                "wall_ms": [w * 1e3 for w in walls],
                "launches": _launch_counts(kernels),
                "metrics": [{k: v.item() for k, v in m.items()}
                            for m in metrics],
                "params": {f"{key}.{n}": p.detach().cpu() for key in
                           trained for n, p in
                           state.models[key].named_parameters()}})
            del state, step, batch, gen, predictor, metrics
            torch.cuda.empty_cache()
    first = runs[0]
    worst, name, unequal = 0.0, None, 0
    for run in runs[1:]:
        if run["launches"] != first["launches"] or \
                0 in run["launches"].values():
            raise AssertionError(f"launches {run['launches']} against "
                                 f"{first['launches']}")
        if run["metrics"] != first["metrics"]:
            raise AssertionError(f"remat_flow={run['remat']} changed the "
                                 f"metrics: {run['metrics']} against "
                                 f"{first['metrics']}")
        for n, p in first["params"].items():
            gap = float((run["params"][n] - p).abs().max()) \
                / max(float(p.abs().max()), 1e-30)
            unequal += not torch.equal(run["params"][n], p)
            if gap >= worst:
                worst, name = gap, n
    if not worst <= REMAT_PARAM_TOL:
        raise AssertionError(f"remat_flow moved {name} by {worst:.3e} of "
                             f"its largest value")
    out = {"steps": 1 + REMAT_TIMED, "order": [r["remat"] for r in runs],
           "param_tensors": len(first["params"]),
           "param_tensors_unequal": unequal, "param_worst_rel": worst,
           "param_worst": name, "metrics_equal": True,
           "nondeterministic_ops": warned, "card": card,
           "runs": [{k: r[k] for k in ("remat", "peak_bytes",
                                       "after_forward_bytes", "wall_ms",
                                       "launches")} for r in runs]}
    for r in runs:
        print(f"remat_flow {'on' if r['remat'] else 'off'}: acoustic step "
              f"(bf16, b{TRAIN_BATCH} x f{TRAIN_FRAMES}, deterministic) "
              f"peak memory {r['peak_bytes'] / 2**30:.3f} GiB, "
              f"{r['after_forward_bytes'] / 2**30:.3f} GiB allocated after "
              f"the speech predictor's forward, warm steps "
              f"{', '.join(f'{w:.1f}' for w in r['wall_ms'])} ms, launches "
              f"over {1 + REMAT_TIMED} steps {r['launches']} [{card}]")
    for label, flag in (("off", False), ("on", True)):
        mine = [r for r in runs if r["remat"] is flag]
        out[label] = {
            "peak_bytes": max(r["peak_bytes"] for r in mine),
            "after_forward_bytes": max(r["after_forward_bytes"]
                                       for r in mine),
            "median_ms": float(np.median([w for r in mine
                                          for w in r["wall_ms"]])),
            "launches": mine[0]["launches"]}
    off, on = out["off"], out["on"]
    out["peak_saved_bytes"] = off["peak_bytes"] - on["peak_bytes"]
    out["forward_saved_bytes"] = (off["after_forward_bytes"]
                                  - on["after_forward_bytes"])
    out["step_time_ratio"] = on["median_ms"] / off["median_ms"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"remat_flow on vs off ({out['seconds']:.1f} s): peak memory "
          f"{out['peak_saved_bytes'] / 2**30:+.3f} GiB saved "
          f"({out['peak_saved_bytes'] / off['peak_bytes']:.1%}), after the "
          f"forward {out['forward_saved_bytes'] / 2**30:+.3f} GiB saved; "
          f"warm step median {on['median_ms']:.1f} against "
          f"{off['median_ms']:.1f} ms (x{out['step_time_ratio']:.3f}); "
          f"metrics bit-equal at all {1 + REMAT_TIMED} steps of all 4 runs;"
          f" {unequal} parameter tensors of {len(first['params'])} x 3 runs "
          f"not bit-equal to the first run's, worst {worst:.3e} of its "
          f"largest value (bound {REMAT_PARAM_TOL}) [{card}]")
    return out


def tools_path(card: str, root: Path) -> dict:
    """The root tools: ``pitch_eval``'s YIN on the card and on the CPU on
    TOOLS_UTTS utterances (tracks within the YIN bounds, cents figures
    within PITCH_CENTS_TOL), ``g2p_eval``'s report (equal to the committed
    ``G2P_r05.json``), and ``train_homographs`` at its default 200 epochs
    into ``root``, its weights compared with the committed file's."""
    from stylish_tts_tpu_torch.scripts import (g2p_eval, pitch_eval,
                                               train_homographs)

    out = {"card": card}
    t0 = time.perf_counter()
    tracks, reports = {}, {}
    for device in ("cuda", "cpu"):
        t1 = time.perf_counter()
        reports[device], tracks[device] = pitch_eval.evaluate(TOOLS_UTTS,
                                                              device)
        reports[device]["seconds"] = time.perf_counter() - t1
    gaps = {}
    for name in ("yin_raw", "yin_stonemask_refined"):
        agree = total = 0
        worst = 0.0
        for a, b in zip(tracks["cuda"][name], tracks["cpu"][name]):
            agree += int(np.sum((a > 0) == (b > 0)))
            total += a.shape[0]
            both = (a > 0) & (b > 0)
            if both.any():
                worst = max(worst, float(np.max(np.abs(a[both] - b[both])
                                                / b[both])))
        gaps[name] = {"voicing_agreement": agree / total,
                      "worst_f0_rel": worst}
        if agree < YIN_VOICING * total or worst > YIN_F0_REL:
            raise AssertionError(f"YIN card vs cpu ({name}): voicing "
                                 f"{agree}/{total}, f0 {worst:.3e}")
        a, b = reports["cuda"][name], reports["cpu"][name]
        off = max(abs(a[k] - b[k]) for k in ("cents_mae", "cents_p95"))
        if off > PITCH_CENTS_TOL or abs(a["vuv_f1"] - b["vuv_f1"]) > 0.01:
            raise AssertionError(f"pitch_eval {name}: card {a} vs cpu {b}")
    out["pitch_eval"] = {"utts": TOOLS_UTTS, "card": reports["cuda"],
                         "cpu": reports["cpu"], "tracks": gaps}
    print(f"pitch_eval on {TOOLS_UTTS} utterances, card: "
          f"{json.dumps(reports['cuda'])}; cpu: {json.dumps(reports['cpu'])}"
          f"; tracks card vs cpu {json.dumps(gaps)} (bounds: cents "
          f"{PITCH_CENTS_TOL}, f0 {YIN_F0_REL}, voicing {YIN_VOICING}) "
          f"[{card}]")

    t1 = time.perf_counter()
    g2p = g2p_eval.evaluate()
    committed = json.loads(Path("G2P_r05.json").read_text())
    out["g2p_eval"] = {"report": g2p, "equals_G2P_r05": g2p == committed,
                       "seconds": time.perf_counter() - t1}
    print(f"g2p_eval ({out['g2p_eval']['seconds']:.1f} s, host): "
          f"{json.dumps(g2p)}")
    if g2p != committed:
        raise AssertionError("g2p_eval's report differs from G2P_r05.json")
    print("g2p_eval: the report equals the committed G2P_r05.json")

    t1 = time.perf_counter()
    report = train_homographs.train(out=root / "homograph_lr.npz")
    same = train_homographs.compare_weights(root / "homograph_lr.npz")
    out["train_homographs"] = {"report": report, "committed": same,
                               "seconds": time.perf_counter() - t1}
    print(f"train_homographs ({out['train_homographs']['seconds']:.1f} s, "
          f"host): {json.dumps(report)}; against the committed "
          f"textfrontend/data/homograph_lr.npz: w, b and alpha "
          f"{'bit-equal' if same['equal'] else 'differ'} (largest "
          f"differences {json.dumps(same['max_abs_diff'])})")
    out["seconds"] = time.perf_counter() - t0
    print(f"tools phase: {out['seconds']:.1f} s [{card}]")
    return out


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


def book_path(card: str, kernels, chain_artifact: Path,
              keep_data: Path) -> dict:
    """From a book's text to a voice through the CLI, at the full-width
    default ModelConfig; see the module docstring, phase 8.  The book's
    dataset is copied to ``keep_data`` for phase 12."""
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
        shutil.copytree(data, keep_data)
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
    from stylish_tts_tpu_torch.models.torch_convert import convert_module
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
        reference = {k: init_params(built[k], generator)
                     for k in REFERENCE_MODELS}
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
    voiced_onset = copy.deepcopy(batch), noise.copy()
    step_hz = mc.sample_rate / 512
    pitch = np.clip(np.round(batch["pitch"] / step_hz), 2, 6) * step_hz
    pitch[:, :3] = 0.0
    batch["pitch"] = pitch.astype(np.float32)
    noise[:, :(3 * 4 - 2) * (mc.hop_length // 4)] = 0.0
    batch["audio_gt"][:, :mc.n_fft // 2 + 1] = 0.0

    def run(device, batch, noise, stages=None):
        state = build_train_state(mc, keys, models=copy.deepcopy(models),
                                  device=device)
        ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                           mel_std=4.0, step_limit=10_000,
                           slm=copy.deepcopy(slm).to(device),
                           ssl=tuple(copy.deepcopy(m).to(device)
                                     for m in ssl))
        with _stage_capture(state.models["hubert_speech_predictor"], ctx,
                            stages):
            _, metrics = make_train_step("hubert_acoustic", ctx, 1e-4)(
                state, on_device(batch, device), sample=False,
                pcph_noise=torch.from_numpy(noise).to(device),
                pcph_phase=torch.zeros(1, 1, device=device))
        return {k: v.item() for k, v in metrics.items()}

    results = {device: run(device, batch, noise)
               for device in ("cpu", "cuda")}
    rel = {}
    for key, bound in STEP_TOL.items():
        a, b = results["cpu"][key], results["cuda"][key]
        rel[key] = abs(a - b) / max(abs(a), 1e-30)
        if not rel[key] <= bound:
            raise AssertionError(f"hubert_acoustic step cpu vs card {key}: "
                                 f"{a} vs {b}")
    print(f"full-width hubert_acoustic step f32 on 1 x 64 frames, cpu vs "
          f"card: relative differences {json.dumps(rel)} [{card}]")
    return {"metrics": results, "relative_difference": rel,
            "voiced_onset": voiced_onset_gaps(run, *voiced_onset, card)}


def voiced_onset_gaps(run, batch, noise, card: str) -> dict:
    """The diagnostic pass of the voiced-onset input (the synthetic batch
    and prior noise as drawn, before the well-posed edits): the step on
    both devices with each stage's output recorded, and the largest gap
    between the two at each stage relative to the CPU's largest value, in
    the order the data flows (``_stage_capture``); phases also modulo
    2 pi.  Nothing is asserted: the asserted check stays on the well-posed
    input."""
    t0 = time.perf_counter()
    stages = {"cpu": {}, "cuda": {}}
    metrics = {d: run(d, batch, noise, stages[d]) for d in stages}
    gaps = {}
    for name, ref in stages["cpu"].items():
        got = stages["cuda"][name]
        scale = max(float(np.max(np.abs(r))) for r in ref)
        gaps[name] = max(float(np.max(np.abs(g - r)))
                         for g, r in zip(got, ref)) / max(scale, 1e-30)
        if "phase" in name:
            gaps[f"{name} mod 2pi"] = max(
                float(np.max(np.abs(np.angle(np.exp(1j * (g - r))))))
                for g, r in zip(got, ref)) / max(scale, 1e-30)
    gaps["metric mel"] = abs(metrics["cpu"]["mel"] - metrics["cuda"]["mel"]) \
        / abs(metrics["cpu"]["mel"])
    gaps["seconds"] = time.perf_counter() - t0
    print(f"voiced-onset input ({gaps['seconds']:.1f} s), hubert_acoustic "
          f"f32 step cpu vs card, the "
          f"largest gap of each stage's output relative to its largest "
          f"value: {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}"
          f" [{card}]")
    return gaps


@contextlib.contextmanager
def _stage_capture(model, ctx, stages):
    """Record into ``stages`` (a dict; nothing without one), as float64
    numpy arrays, each stage's output of one step of the hubert speech
    predictor: the frozen HuBERT features and speaker vector, the PCPH
    prior, its STFT's magnitude and phase, the generator's input latent,
    its log-magnitude and phase, the audio, and the mel spectrograms of
    the prediction that the mel loss reads (3 resolutions)."""
    from stylish_tts_tpu_torch.models import generator as gen_mod

    if stages is None:
        yield
        return

    def keep(name, *tensors):
        stages.setdefault(name, []).extend(
            t.detach().double().cpu().numpy() for t in tensors)

    real_pcph, real_ssl = gen_mod.generate_pcph, ctx.ssl_features
    head = model.generator.stft_head
    real_transform = head.transform
    real_spec = ctx.multi_spectrogram

    def pcph(*args, **kwargs):
        out = real_pcph(*args, **kwargs)
        keep("prior", out)
        return out

    def ssl(*args, **kwargs):
        feats, spk = real_ssl(*args, **kwargs)
        keep("hubert features", feats)
        keep("speaker vector", spk)
        return feats, spk

    def transform(x):
        mag, cos, sin = real_transform(x)
        keep("prior stft magnitude", mag)
        keep("prior stft phase", torch.atan2(sin, cos))
        return mag, cos, sin

    def spec(*, target, pred):
        out = real_spec(target=target, pred=pred)
        keep("mel (3 resolutions)", *out[1])
        return out

    def on_generator(module, args, output):
        keep("generator input", args[0])
        keep("generator log-magnitude", output.magnitude)
        keep("generator phase", output.phase)
        keep("audio", output.audio)

    gen_mod.generate_pcph = pcph
    ctx.ssl_features, head.transform, ctx.multi_spectrogram = \
        ssl, transform, spec
    hook = model.generator.register_forward_hook(on_generator)
    try:
        yield
    finally:
        hook.remove()
        gen_mod.generate_pcph = real_pcph
        ctx.ssl_features, ctx.multi_spectrogram = real_ssl, real_spec
        del head.transform


# --------------------------------------------------------------------------- #
# the ringformer head, data parallelism and the MPD


def _ring_counts(kernels) -> dict:
    """The kernels' launch counts and the STFT's launches at the
    ringformer's n_fft, which its DFT path serves."""
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    return {**_launch_counts(kernels),
            "stft_dft": stft_forward.launches_by_n_fft.get(RING_N_FFT, 0)}


def _ring_recording(make, record: list, kernels):
    """``make`` whose steps append each call's launches (the STFT's DFT
    path apart), collectives, wall ms, batch shape and, for an eval step's
    audio, its shape, peak and finiteness to ``record``."""
    from stylish_tts_tpu_torch.parallel import mesh

    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(state, batch, *a, **k):
            before, coll = _ring_counts(kernels), dict(mesh.COLLECTIVES)
            t0 = time.perf_counter()
            out = fn(state, batch, *a, **k)
            torch.cuda.synchronize()
            entry = {"ms": (time.perf_counter() - t0) * 1e3,
                     "shape": list(batch["audio_gt"].shape),
                     "launches": {n: c - before[n] for n, c in
                                  _ring_counts(kernels).items()},
                     "collectives": {n: c - coll.get(n, 0) for n, c in
                                     mesh.COLLECTIVES.items()}}
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


def _ring_hook(kernels, record: dict):
    """The run's ``on_stage``: at the start the head's log-amplitude conv
    is brought to a trained model's level (RING_POST_SCALE), the launch
    counts go to 0, the models (the conformers' running stats with them)
    are copied to the host and each model's trained parameters counted;
    at the end each model's moved tensors are listed."""
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

    def hook(event: str, stage: str, state) -> None:
        torch.cuda.synchronize()
        record["events"].append([event, stage])
        if event == "start":
            with torch.no_grad():
                state.models["speech_predictor"].generator.conv_post \
                    .weight.mul_(RING_POST_SCALE)
            for k in kernels:
                k.launches = 0
            stft_forward.launches_by_n_fft.clear()
            record["start"] = {k: {n: t.cpu().clone() for n, t in
                                   m.state_dict().items()}
                               for k, m in state.models.items()}
            record["numels"] = {k: sum(p.numel() for p in m.parameters()
                                       if p.requires_grad)
                                for k, m in state.models.items()}
        elif event == "end":
            record["launches"] = _ring_counts(kernels)
            record["moved"] = {
                key: [n for n, t in m.state_dict().items()
                      if not torch.equal(t.cpu(), record["start"][key][n])]
                for key, m in state.models.items()}

    return hook


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and torch's deterministic mode
    (warn only) while the block runs; yields the sorted list, filled at
    the end, of the ops torch warned have no deterministic implementation
    here."""
    import os
    import warnings

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    # cuBLAS is deterministic on one stream; torch asks for this setting
    # before it says so
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    warned: list = []
    seen: set = set()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda message, *a, **k: seen.add(
                str(message).split(" does not have")[0][:200]) \
                if "deterministic" in str(message) else None
            yield warned
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]
        warned.extend(sorted(seen))


def _ring_run(root: Path, data: Path, name: str, kernels, card: str,
              extra: list) -> dict:
    """CLI ``train --stage acoustic`` with the ringformer head at full
    width on ``data`` for RING_STEPS steps, a validation at the last; the
    run's record (steps, launches, collectives, moved tensors, stats)."""
    import functools

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import (Config, ModelConfig,
                                              RingformerGeneratorConfig,
                                              dump_json)
    from stylish_tts_tpu_torch.train import loop

    mc = ModelConfig()
    mc.generator = RingformerGeneratorConfig()
    cfg = Config()
    cfg.dataset.path = str(data)
    plan = cfg.training_plan.acoustic
    plan.epochs, plan.probe_batch_max = 1, RING_BATCH
    cfg.training.log_interval = 1
    cfg.training.val_interval = RING_STEPS
    cfg.training.save_interval = 10 ** 6
    cfg.training.aot_memory_plan = False
    (root / "config.json").write_text(dump_json(cfg))
    (root / "model.json").write_text(dump_json(mc))
    out = root / f"out_{name}"
    rec: dict = {"events": []}
    train_calls, eval_calls = [], []
    originals = (loop.train_model, loop.make_train_step, loop.make_eval_step)
    loop.train_model = functools.partial(originals[0],
                                         on_stage=_ring_hook(kernels, rec))
    loop.make_train_step = _ring_recording(originals[1], train_calls,
                                           kernels)
    loop.make_eval_step = _ring_recording(originals[2], eval_calls, kernels)
    t0 = time.perf_counter()
    try:
        cli.main(["train", "--config", str(root / "config.json"),
                  "--model-config", str(root / "model.json"), "--out",
                  str(out), "--stage", "acoustic", "--max-steps",
                  str(RING_STEPS), *extra])
    finally:
        loop.train_model, loop.make_train_step, loop.make_eval_step = \
            originals
    rec["seconds"] = time.perf_counter() - t0
    stats = json.loads((out / "acoustic" / "train_stats.json").read_text())
    if rec["events"] != [["start", "acoustic"], ["planned", "acoustic"],
                         ["end", "acoustic"]] or stats["steps"] != \
            RING_STEPS or len(train_calls) != RING_STEPS:
        raise AssertionError(f"ringformer {name}: events {rec['events']}, "
                             f"{stats['steps']} steps")
    rec.update(stats=stats, train_calls=train_calls, eval_calls=eval_calls,
               out=out)
    return rec


def _check_ring_run(name: str, rec: dict, hop: int) -> dict:
    """The run's checks (models moved, the conformers' running stats
    moved, finite metrics, validation audio finite, not silent and F x 300
    samples long, the launches of every step and eval batch); returns its
    step and eval launches."""
    from stylish_tts_tpu_torch.train.stages import STAGES

    stats = rec["stats"]
    st = STAGES["acoustic"]
    for key in st.train_models + st.discriminators:
        if not rec["moved"][key]:
            raise AssertionError(f"ringformer {name}: {key} did not move")
    bn = [n for n in rec["moved"]["speech_predictor"]
          if ".conv.bn." in n and n.endswith((".mean", ".var"))]
    if not bn:
        raise AssertionError(f"ringformer {name}: no conformer running "
                             f"stat moved")
    values = [e["loss"] for e in stats["logs"]] + [
        v for e in stats["logs"] for v in e["metrics"].values()] + [
        v["loss"] for v in stats["validations"]] + [
        m for v in stats["validations"] for m in v["metrics"].values()]
    if len(stats["validations"]) != 1 or not all(np.isfinite(values)):
        raise AssertionError(f"ringformer {name}: validations "
                             f"{stats['validations']}, non-finite metrics")
    per_layer = {f"spec_conv_{n}": k * len(mrd_layers())
                 for n, k in LAUNCHES_PER_LAYER.items()}
    want_train = {"stft_forward": RING_STFT["train"]["all"],
                  "stft_dft": RING_STFT["train"]["dft"], **per_layer}
    want_eval = {"stft_forward": RING_STFT["eval"]["all"],
                 "stft_dft": RING_STFT["eval"]["dft"],
                 **{k: 0 for k in per_layer}}
    for i, call in enumerate(rec["train_calls"]):
        if call["launches"] != want_train:
            raise AssertionError(f"ringformer {name} step {i} launched "
                                 f"{call['launches']}, want {want_train}")
    if not rec["eval_calls"]:
        raise AssertionError(f"ringformer {name}: no eval batch")
    for i, call in enumerate(rec["eval_calls"]):
        if call["launches"] != want_eval:
            raise AssertionError(f"ringformer {name} eval batch {i} "
                                 f"launched {call['launches']}, want "
                                 f"{want_eval}")
        frames = call["shape"][1] // hop + 1
        length = (frames - frames % 2) * hop
        audio = call["audio"]
        if audio["shape"] != [call["shape"][0], length] or not \
                audio["finite"] or not audio["max_abs"] > 0:
            raise AssertionError(f"ringformer {name}: eval audio {audio}, "
                                 f"want {length} samples")
    return {"train": want_train, "eval": want_eval, "bn_moved": len(bn)}


def _read_models(ckpt: Path) -> dict:
    from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

    return {p.stem: read_safetensors(p)
            for p in sorted((ckpt / "models").glob("*.safetensors"))}


def ring_numbers(device, card: str, flush: torch.Tensor) -> dict:
    """The STFT's DFT path at the ringformer step's 60/15/60 on [8,
    138000]: held against the plain version and torch.stft, timed beside
    them and its bound."""
    x = torch.from_numpy(np.random.default_rng(80).standard_normal(
        (TRAIN_BATCH, TRAIN_FRAMES * 300)).astype(np.float32)).to(device)
    r = stft_numbers(x, RING_N_FFT, RING_HOP, RING_N_FFT, flush)
    print(f"stft DFT path n_fft={RING_N_FFT} hop={RING_HOP} "
          f"win={RING_N_FFT} x={r['shape']}: {stft_line(r)} [{card}]")
    return r


def cpu_vs_card_ring_step(card: str) -> dict:
    """One f32 ringformer acoustic step at full width on 1 x 64 frames from
    the same weights on the CPU (plain versions) and on the card (kernels),
    dropout off, latent means and the same source draws; the metrics
    compared under STEP_TOL; the head's log-amplitude conv at
    RING_POST_SCALE, as in the runs.  The F0 is on the 24000/512 Hz grid,
    unvoiced for 3 frames, and the source's draws are 0 under STFT frame
    0, so the source is 0 there on both devices (the frame is real, its
    phase 0 or pi by the sign of a rounding otherwise)."""
    import copy

    from stylish_tts_tpu_torch.config import (Config, ModelConfig,
                                              RingformerGeneratorConfig)
    from stylish_tts_tpu_torch.models.norms import Dropout
    from stylish_tts_tpu_torch.train.init import (build_training_models,
                                                  init_params)

    mc = ModelConfig()
    mc.generator = RingformerGeneratorConfig()
    cfg = Config()
    cfg.training.mixed_precision = "no"
    keys = ("speech_predictor", "pitch_energy_predictor", "pe_text_encoder",
            "pe_mel_style_encoder", "mrd")
    built = build_training_models(mc, keys)
    gen = torch.Generator().manual_seed(81)
    models = {k: init_params(built[k], gen) for k in keys}
    for model in models.values():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    with torch.no_grad():
        models["speech_predictor"].generator.conv_post.weight.mul_(
            RING_POST_SCALE)
    frames = 64
    batch = synthetic_batch(mc, 1, frames, 82)
    step_hz = mc.sample_rate / 512
    pitch = np.clip(np.round(batch["pitch"] / step_hz), 2, 6) * step_hz
    pitch[:, :3] = 0.0
    batch["pitch"] = pitch.astype(np.float32)
    batch["audio_gt"][:, :mc.n_fft // 2 + 1] = 0.0
    rng = np.random.default_rng(83)
    samples = frames * mc.hop_length
    draws = {"phase": rng.random((1, 1, 9)).astype(np.float32),
             "noise": rng.standard_normal((1, samples, 9)).astype(
                 np.float32),
             "noise_uv": rng.standard_normal((1, samples, 9)).astype(
                 np.float32)}
    for key in ("noise", "noise_uv"):
        draws[key][:, :2 * RING_N_FFT] = 0.0
    results = {}
    for device in ("cpu", "cuda"):
        state, step = train_setup(mc, cfg, device, seed=84,
                                  models=copy.deepcopy(models))
        _, metrics = step(state, on_device(batch, device), sample=False,
                          nsf_draws=on_device(draws, device))
        results[device] = {k: v.item() for k, v in metrics.items()}
        del state, step
    rel = {}
    for key, bound in STEP_TOL.items():
        a, b = results["cpu"][key], results["cuda"][key]
        rel[key] = abs(a - b) / max(abs(a), 1e-30)
        if not rel[key] <= bound:
            raise AssertionError(f"ringformer step cpu vs card {key}: {a} "
                                 f"vs {b}")
    print(f"full-width ringformer step f32 on 1 x 64 frames, cpu vs card: "
          f"relative differences {json.dumps(rel)} [{card}]")
    return {"metrics": results, "relative_difference": rel}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def allreduce_ms(device, numels: dict) -> dict:
    """Device ms of one NCCL all-reduce of each trained module's flat
    gradient bucket (f32, ``numels``), median of 10 by CUDA events."""
    import torch.distributed as dist

    out = {}
    for key, n in numels.items():
        buf = torch.zeros(n, device=device)
        out[key] = time_ms(lambda: dist.all_reduce(buf))
    return out


def mpd_path(device, card: str, root: Path) -> dict:
    """The MPD: a seeded reference state dict through CLI ``import-torch
    --model mpd``, the file loaded into the port's MPD (every tensor equal
    to its source); forward and backward at [8, 138000] f32 on the card,
    timed; the same on the CPU and on the card at MPD_CPU_SHAPE, held
    within MPD_TOL."""
    import copy

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.export.import_torch import \
        load_converted_module
    from stylish_tts_tpu_torch.models.discriminator import \
        MultiPeriodDiscriminator
    from stylish_tts_tpu_torch.train.init import init_params
    from stylish_tts_tpu_torch.utils.synthetic import reference_state_dict

    t0 = time.perf_counter()
    source = init_params(MultiPeriodDiscriminator(),
                         torch.Generator().manual_seed(90))
    sd = reference_state_dict("mpd", source)
    path = root / "pytorch_model_5.bin"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    cli.main(["import-torch", "--checkpoint", str(path), "--out",
              str(root / "mpd_out"), "--model", "mpd"])
    mpd = load_converted_module(root / "mpd_out" / "mpd.safetensors", "mpd",
                                MultiPeriodDiscriminator())
    want = source.state_dict()
    for k, t in mpd.state_dict().items():
        if not torch.equal(t, want[k]):
            raise AssertionError(f"mpd: {k} is not its source's")
    import_s = time.perf_counter() - t0

    def loss_of(model, target, pred):
        real, gen, fr, fg = model(target, pred)
        loss = sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2)
                   for r, g in zip(real, gen))
        return loss + sum(torch.mean(torch.abs(a - b))
                          for x, y in zip(fr, fg) for a, b in zip(x, y))

    def run(model, target, pred):
        model.zero_grad(set_to_none=True)
        pred = pred.clone().requires_grad_()
        loss = loss_of(model, target, pred)
        loss.backward()
        return loss.detach(), pred.grad

    rng = np.random.default_rng(91)
    card_mpd = copy.deepcopy(mpd).to(device)
    big = [torch.from_numpy((0.3 * rng.standard_normal(MPD_SHAPE))
                            .astype(np.float32)).to(device)
           for _ in range(2)]
    ms = time_ms(lambda: run(card_mpd, *big), iters=3)
    loss_big, _ = run(card_mpd, *big)
    if not torch.isfinite(loss_big):
        raise AssertionError(f"mpd loss at {MPD_SHAPE}: {loss_big}")
    del big
    small = [(0.3 * rng.standard_normal(MPD_CPU_SHAPE)).astype(np.float32)
             for _ in range(2)]
    got = run(card_mpd, *(torch.from_numpy(a).to(device) for a in small))
    ref = run(mpd, *(torch.from_numpy(a) for a in small))
    err = {"loss": abs(float(got[0]) - float(ref[0])) / abs(float(ref[0])),
           "d_pred": float((got[1].cpu() - ref[1]).abs().max()
                           / ref[1].abs().max())}
    w = "period_2.conv_4.weight"
    gw = dict(card_mpd.named_parameters())[w].grad.cpu()
    rw = dict(mpd.named_parameters())[w].grad
    err["d_" + w] = float((gw - rw).abs().max() / rw.abs().max())
    if not all(v <= MPD_TOL for v in err.values()):
        raise AssertionError(f"mpd cpu vs card: {err}")
    del card_mpd
    torch.cuda.empty_cache()
    print(f"mpd: import-torch --model mpd and load {import_s:.1f} s "
          f"({len(want)} tensors equal); forward + backward at {MPD_SHAPE} "
          f"f32 {ms:.1f} ms; cpu vs card at {MPD_CPU_SHAPE}: relative "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in err.items()})} "
          f"[{card}]")
    return {"import_s": import_s, "tensors": len(want),
            "shape": list(MPD_SHAPE), "fwd_bwd_ms": ms,
            "cpu_vs_card": err, "cpu_shape": list(MPD_CPU_SHAPE)}


def ringformer_path(device, card: str, kernels, data: Path,
                    flush: torch.Tensor) -> dict:
    """The ringformer head, data-parallel training and the MPD at full
    width on phase 7's dataset ``data``; see the module docstring, phase
    11."""
    import os
    import tempfile

    import torch.distributed as dist

    from stylish_tts_tpu_torch.parallel import mesh
    from stylish_tts_tpu_torch.parallel.multihost import (
        initialize_distributed, shutdown_distributed)

    t_phase = time.perf_counter()
    hop = 300
    record: dict = {"card": card, "dft": ring_numbers(device, card, flush)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_") as tmp:
        root = Path(tmp)
        with deterministic_algorithms() as warned_plain:
            plain = _ring_run(root, data, "plain", kernels, card, [])
        record["launches_per_step"] = _check_ring_run("plain", plain, hop)
        # the same run data-parallel: a world of one on NCCL, joined from
        # torchrun's environment
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(_free_port()))
        initialize_distributed(device="cuda", timeout_s=300)
        try:
            with deterministic_algorithms() as warned_dp:
                dp = _ring_run(root, data, "distributed", kernels, card,
                               ["--distributed"])
            _check_ring_run("distributed", dp, hop)
            from stylish_tts_tpu_torch.train.stages import STAGES

            st = STAGES["acoustic"]
            record["allreduce_ms"] = allreduce_ms(
                device, {k: dp["numels"][k]
                         for k in st.train_models + st.discriminators})
        finally:
            shutdown_distributed()
            for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT"):
                os.environ.pop(key, None)
        # the two runs: the same batches; every step's metrics, the weights
        # and the batch stats (running moments, spectral-norm vectors)
        # within RING_RUN_TOL; checked after the comparison is printed
        if plain["stats"]["batches"] != dp["stats"]["batches"]:
            raise AssertionError("ringformer: the distributed run took other "
                                 "batches")
        rel, failed = {}, []
        for i, (a, b) in enumerate(zip(plain["stats"]["logs"],
                                       dp["stats"]["logs"])):
            for key in STEP_TOL:
                x = a["metrics"].get(key, a["loss"] if key == "loss" else None)
                y = b["metrics"].get(key, b["loss"] if key == "loss" else None)
                if x is None:
                    continue
                r = abs(x - y) / max(abs(x), 1e-30)
                rel[f"{key}@{i + 1}"] = r
                if not r <= RING_RUN_TOL:
                    failed.append(f"step {i + 1} {key}: {x} vs {y}")
        wa = _read_models(plain["out"] / "acoustic" / "checkpoint_final")
        wb = _read_models(dp["out"] / "acoustic" / "checkpoint_final")
        weights, stats_rel = {}, {}
        for key, tensors in wa.items():
            for out, names in (
                    (weights, [n for n in tensors
                               if n.rsplit("/", 1)[-1] not in BATCH_STATS]),
                    (stats_rel, [n for n in tensors
                                 if n.rsplit("/", 1)[-1] in BATCH_STATS])):
                if not names:
                    continue
                scale = max(float(np.abs(tensors[n]).max()) for n in names)
                worst, name = max((float(np.abs(tensors[n] - wb[key][n])
                                         .max()), n) for n in names)
                out[key] = worst / max(scale, 1e-30)
                out[f"{key} worst"] = name
                if not out[key] <= RING_RUN_TOL:
                    failed.append(f"{key}'s {name}: {out[key]:.3e} of its "
                                  f"largest")
        coll = [c["collectives"] for c in dp["train_calls"]]
        for name, rec in (("plain", plain), ("distributed", dp)):
            seen, first, warm = set(), [], []
            for call in rec["train_calls"]:
                key = tuple(call["shape"])
                (warm if key in seen else first).append(round(call["ms"]))
                seen.add(key)
            record[name] = {
                "seconds": rec["seconds"], "batches": rec["stats"]["batches"],
                "step_ms": {"first_visit": first, "warm": warm},
                "eval_ms": [round(c["ms"]) for c in rec["eval_calls"]],
                "eval_audio": [c["audio"] for c in rec["eval_calls"]],
                "logs": rec["stats"]["logs"],
                "validations": rec["stats"]["validations"]}
            print(f"ringformer {name}: CLI train {rec['seconds']:.1f} s for "
                  f"{RING_STEPS} steps {rec['stats']['batches']}, wall ms "
                  f"first visit {first}, warm {warm or 'none'}; validation "
                  f"{record[name]['eval_ms']} ms; every step launched "
                  f"{record['launches_per_step']['train']}, every eval "
                  f"batch {record['launches_per_step']['eval']}; "
                  f"{record['launches_per_step']['bn_moved']} conformer "
                  f"running stats moved [{card}]")
        record["distributed"].update(collectives_per_step=coll,
                                     metrics_rel=rel, weights_rel=weights,
                                     batch_stats_rel=stats_rel)
        record["nondeterministic_ops"] = {"plain": warned_plain,
                                          "distributed": warned_dp}
        def short(d: dict) -> str:
            return json.dumps({k: float(f"{v:.3e}") if isinstance(
                v, float) else v for k, v in d.items()})

        buckets = record["allreduce_ms"]
        print(f"ringformer distributed (NCCL, world 1) vs plain: metrics "
              f"{short(rel)}, weights {short(weights)}, batch stats "
              f"{short(stats_rel)}; collectives per "
              f"step {coll[-1]}; one all-reduce of each module's gradient "
              f"bucket {short(buckets)} ms ({sum(buckets.values()):.3f} ms "
              f"a step); both runs under deterministic algorithms, ops "
              f"torch warned of {json.dumps(record['nondeterministic_ops'])}"
              f" [{card}]")
        if failed:
            raise AssertionError(f"ringformer distributed vs plain: "
                                 f"{failed}")
        # the DFT path (and the STFT's and spec-conv kernels' other paths)
        # against their plain versions at every batch shape the runs took
        shapes = sorted({tuple(c["shape"]) for rec in (plain, dp)
                         for c in rec["train_calls"] + rec["eval_calls"]})
        record["batch_shape_checks"] = batch_shape_checks(shapes, card)
        record["dft_shape_checks"] = checks = []
        for s in shapes:
            x = torch.randn(*s, device=device, generator=torch.Generator(
                device=device).manual_seed(s[1] + 1))
            err = stft_error(x, RING_N_FFT, RING_HOP, RING_N_FFT)[2]
            checks.append({"shape": list(s), "max_abs_err": err})
            del x
        print(f"ringformer: the STFT's DFT path held at {RING_N_FFT}/"
              f"{RING_HOP}/{RING_N_FFT} at the runs' batch shapes {shapes} "
              f"(max err {max(r['max_abs_err'] for r in checks):.2e}) "
              f"[{card}]")
        torch.cuda.empty_cache()
        record["cpu_vs_card"] = cpu_vs_card_ring_step(card)
        record["mpd"] = mpd_path(device, card, root)
    record["seconds"] = time.perf_counter() - t_phase
    print(f"ringformer phase: {record['seconds']:.1f} s [{card}]")
    return record


# --------------------------------------------------------------------------- #
# RMVPE pitch on the book's dataset and the conversion scripts


def _same_flat(got: dict, want: dict, what: str) -> None:
    """Two flat dicts of arrays: the same names, every array bit-equal."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: names differ by "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    for k in want:
        if not np.array_equal(got[k], np.asarray(want[k])):
            raise AssertionError(f"{what}: {k} differs")


def conversion_scripts(root: Path, rmvpe_sd: dict, rmvpe_file: Path,
                       card: str) -> dict:
    """The port's five conversion scripts on seeded inputs, each file equal
    to the in-process conversion of the same input: RMVPE's (already
    written by phase 12), the speaker net's and Vocos's from seeded
    full-width modules' reference state dicts (the speaker net's wrapped
    as wespeaker's checkpoints hold it), WavLM's and HuBERT's from seeded
    full-width SSL encoders written as local HF checkpoint directories
    through ``tensorfile`` (which also convert back to the encoders' own
    flax names, the positional conv's folded weight norm within
    SSL_FOLD_REL)."""
    from stylish_tts_tpu_torch.convert import export_flax_params
    from stylish_tts_tpu_torch.models import torch_convert
    from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu_torch.models.slm_convert import \
        convert_checkpoint_directory
    from stylish_tts_tpu_torch.models.vocos import Vocos
    from stylish_tts_tpu_torch.models.wespeaker import SimAMResNet34ASP
    from stylish_tts_tpu_torch.scripts import (convert_hubert,
                                               convert_vocos, convert_wavlm,
                                               convert_wespeaker)
    from stylish_tts_tpu_torch.train.init import init_params
    from stylish_tts_tpu_torch.utils.synthetic import (reference_state_dict,
                                                       write_ssl_checkpoint)
    from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

    record = {}
    params, stats = torch_convert.convert_rmvpe(rmvpe_sd)
    _same_flat(read_safetensors(rmvpe_file), {
        **params, **{f"__batch_stats__/{k}": np.atleast_1d(v)
                     for k, v in stats.items()}}, "convert_rmvpe")
    record["rmvpe"] = len(params) + len(stats)
    gen = torch.Generator().manual_seed(RMVPE_SEED + 1)
    for name, module, script in (
            ("wespeaker", SimAMResNet34ASP(), convert_wespeaker),
            ("vocos", Vocos(), convert_vocos)):
        t0 = time.perf_counter()
        sd = reference_state_dict(name, init_params(module, gen))
        state = {k: torch.from_numpy(v) for k, v in sd.items()}
        src, dst = root / f"{name}.pt", root / f"{name}.safetensors"
        torch.save({"model": state} if name == "wespeaker" else state, src)
        script.main([str(src), str(dst)])
        _same_flat(read_safetensors(dst),
                   torch_convert.CONVERTERS[name](sd), f"convert_{name}")
        record[name] = len(sd)
        print(f"rmvpe phase: scripts/convert_{name}.py on a seeded "
              f"full-width state dict of {len(sd)} tensors: the file is the "
              f"in-process conversion, {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
    for name, module, script in (
            ("wavlm", SLMFeatureExtractor(), convert_wavlm),
            ("hubert", SLMFeatureExtractor(n_layers=6, rel_pos_bias=False),
             convert_hubert)):
        t0 = time.perf_counter()
        hf = write_ssl_checkpoint(root / name, init_params(module, gen))
        dst = root / f"{name}.safetensors"
        script.main(["--model", str(hf), "--out", str(dst)])
        got = read_safetensors(dst)
        _same_flat(got, convert_checkpoint_directory(
            hf, gated=module.rel_pos_bias), f"convert_{name}")
        own = export_flax_params("slm", module)
        for k, v in own.items():
            gap = float(np.abs(got[k] - v).max())
            if k == "pos_conv/kernel":
                if not gap <= SSL_FOLD_REL * float(np.abs(v).max()):
                    raise AssertionError(f"convert_{name}: {k} off by {gap}")
            elif gap != 0.0:
                raise AssertionError(f"convert_{name}: {k} off by {gap}")
        record[name] = len(got)
        print(f"rmvpe phase: scripts/convert_{name}.py on a seeded "
              f"{module.n_layers}-layer HF directory: {len(got)} tensors, "
              f"the in-process conversion, {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
    return record


def stft_at_lengths(lengths, n_fft: int, hop: int, win: int,
                    flush: torch.Tensor, card: str) -> dict:
    """The STFT kernel on [1, T] at every T of ``lengths``, against its
    plain version and torch.stft; timed at the longest beside its bound
    (``stft_numbers``), returned with the lengths and the worst errors."""
    t0 = time.perf_counter()
    worst = lib_worst = 0.0
    for t in lengths:
        gen = torch.Generator(device="cuda").manual_seed(t)
        x = 0.1 * torch.randn(1, t, generator=gen, device="cuda")
        real, imag, err = stft_error(x, n_fft, hop, win)
        worst = max(worst, err)
        lib_worst = max(lib_worst, stft_vs_torch(x, real, imag, n_fft, hop,
                                                 win))
    numbers = stft_numbers(x, n_fft, hop, win, flush)
    print(f"rmvpe phase: stft at {n_fft}/{hop}/{win} held at the run's "
          f"{len(lengths)} lengths (max err {worst:.2e}, vs torch.stft "
          f"{lib_worst:.2e}), {time.perf_counter() - t0:.1f} s; at the "
          f"longest, {numbers['shape']}: {stft_line(numbers)} [{card}]")
    return {**numbers, "lengths": list(lengths), "worst_err": worst,
            "worst_err_vs_torch_stft": lib_worst}


def rmvpe_path(device, card: str, kernels, data: Path,
               flush: torch.Tensor) -> dict:
    """RMVPE pitch through CLI ``pitch --method rmvpe`` on phase 8's book
    dataset ``data`` from a seeded full-width weights file, and the five
    conversion scripts; see the module docstring, phase 12."""
    import tempfile

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.config import Config, ModelConfig, dump_json
    from stylish_tts_tpu_torch.data.audio import read_wav, wav_info
    from stylish_tts_tpu_torch.dataprep import rmvpe as rm
    from stylish_tts_tpu_torch.ops.resample import resample
    from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward
    from stylish_tts_tpu_torch.scripts import convert_rmvpe
    from stylish_tts_tpu_torch.utils.synthetic import (reference_state_dict,
                                                       seeded_rmvpe)
    from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors

    t_phase = time.perf_counter()
    mc = ModelConfig()
    hop = mc.hop_length
    record: dict = {"card": card, "seconds": {}}
    seconds = record["seconds"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rmvpe_") as tmp:
        root = Path(tmp)
        # the weights: a seeded full-width net as the reference's state
        # dict, through the port's script, loaded on the card
        t0 = time.perf_counter()
        model = seeded_rmvpe(RMVPE_SEED)
        sd = reference_state_dict("rmvpe", model)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   root / "rmvpe.pt")
        weights = root / "rmvpe.safetensors"
        convert_rmvpe.main([str(root / "rmvpe.pt"), str(weights)])
        net = rm.RMVPEInference(str(weights), device=device)
        loaded = net.model.state_dict()
        for k, v in model.state_dict().items():
            if not torch.equal(loaded[k].cpu(), v):
                raise AssertionError(f"rmvpe: {k} is not its source")
        seconds["weights"] = time.perf_counter() - t0
        print(f"rmvpe phase: {len(sd)} reference tensors through "
              f"scripts/convert_rmvpe.py, loaded on the card, every tensor "
              f"its source, {seconds['weights']:.1f} s [{card}]")

        # CLI pitch --method rmvpe on the book's dataset
        cfg = Config()
        cfg.dataset.path = str(data)
        (root / "config.json").write_text(dump_json(cfg))
        segments = {}
        for split in ("train", "val"):
            for line in (data / f"{split}-list.txt").read_text().splitlines():
                name = line.split("|")[0]
                segments[name] = wav_info(data / "wav24" / name).frames
        shapes: list = []
        restore = _record_stft_shapes(shapes)
        for k in kernels:
            k.launches = 0
        stft_forward.launches_by_n_fft.clear()
        t0 = time.perf_counter()
        try:
            cli.main(["pitch", "--config", str(root / "config.json"),
                      "--method", "rmvpe", "--rmvpe-weights", str(weights)])
        finally:
            restore()
        torch.cuda.synchronize()
        seconds["pitch"] = time.perf_counter() - t0
        launches = _launch_counts(kernels)
        by_n_fft = dict(stft_forward.launches_by_n_fft)
        n = len(segments)
        pitch = read_safetensors(data / "pitch.safetensors")
        if set(pitch) != set(segments):
            raise AssertionError(f"rmvpe: pitch for {len(pitch)} of {n} "
                                 f"segments")
        for name, f0 in pitch.items():
            if f0.shape != (segments[name] // hop + 1,) or not np.all(
                    np.isfinite(f0)) or not np.all(f0 >= 0):
                raise AssertionError(f"rmvpe: {name}: f0 {f0.shape}, "
                                     f"min {f0.min()}")
        taken = [s for s in shapes if s[2:] == (rm.N_FFT, rm.HOP, rm.WIN)]
        if (len(taken) != n or len(shapes) != n or by_n_fft != {rm.N_FFT: n}
                or launches["stft_forward"] != n
                or any(s[0] != 1 for s in taken)):
            raise AssertionError(f"rmvpe: {n} segments, STFT launches "
                                 f"{launches} by n_fft {by_n_fft}, shapes "
                                 f"{shapes}")
        if any(v for k, v in launches.items() if k != "stft_forward"):
            raise AssertionError(f"rmvpe: other kernels ran: {launches}")
        voiced = float(np.mean(np.concatenate(list(pitch.values())) > 0))
        audio_s = sum(segments.values()) / mc.sample_rate
        record.update(segments=n, audio_s=audio_s, launches=launches,
                      launches_per_file=launches["stft_forward"] // n,
                      voiced_share=voiced,
                      seconds_per_segment=seconds["pitch"] / n,
                      frames=sorted(s[1] // rm.HOP + 1 for s in taken))
        print(f"rmvpe phase: pitch --method rmvpe {seconds['pitch']:.2f} s "
              f"for {n} segments ({audio_s:.1f} s of audio), "
              f"{record['seconds_per_segment']:.3f} s a segment; one STFT "
              f"launch a file at {rm.N_FFT}/{rm.HOP}/{rm.WIN} (B = 1, "
              f"{min(record['frames'])}-{max(record['frames'])} frames), "
              f"launches {launches}; {100 * voiced:.1f}% of the frames "
              f"voiced [{card}]")

        # the STFT kernel at every length the run took, against its plain
        # version and torch.stft; timed at the longest beside its bound
        record["stft"] = stft_at_lengths(sorted({s[1] for s in taken}),
                                         rm.N_FFT, rm.HOP, rm.WIN, flush,
                                         card)

        # one segment's salience on the card against the CPU, f32, TF32 off
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise AssertionError("rmvpe: TF32 is on")
        name = min(segments, key=segments.get)
        wave = torch.from_numpy(read_wav(data / "wav24" / name,
                                         mc.sample_rate)[None])
        wave16 = resample(wave, mc.sample_rate, rm.SAMPLE_RATE)[0]
        cpu = rm.RMVPEInference(str(weights), device="cpu")
        on_cpu = cpu.salience(wave16)
        on_card = net.salience(wave16.to(device)).cpu()
        gap = float((on_card - on_cpu).abs().max())
        if on_card.shape != on_cpu.shape or not gap <= RMVPE_CPU_TOL:
            raise AssertionError(f"rmvpe: card vs cpu salience {gap:.2e}")
        record["cpu_vs_card"] = {"segment": name, "frames": on_cpu.shape[0],
                                 "max_abs_err": gap}
        print(f"rmvpe phase: salience of {name} ({on_cpu.shape[0]} frames) "
              f"on the card against the CPU: max err {gap:.2e} (bound "
              f"{RMVPE_CPU_TOL}) [{card}]")

        t0 = time.perf_counter()
        record["scripts"] = conversion_scripts(root, sd, weights, card)
        seconds["scripts"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    record["seconds"]["phase"] = time.perf_counter() - t_phase
    print(f"rmvpe phase: {record['seconds']['phase']:.1f} s [{card}]")
    return record


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


def pipelined_batches(synth, batch, hop: int, kernels, card: str) -> dict:
    """Two ``synthesize_batch_async`` batches (the halves of ``batch``)
    dispatched back to back before either is read, with no operation torch's
    sync debug mode flags, each bit-equal to ``synthesize_batch`` from the
    same generator state; the launch counts are set to 0 just before the
    dispatches and read just after the reads."""
    import warnings

    state = synth.generator.get_state()
    halves = (batch[: len(batch) // 2], batch[len(batch) // 2:])
    for k in kernels:
        k.launches = 0
    # torch's sync debug mode warns of each operation that waits for the
    # card (it sees most, not all): the dispatches must hold none
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            pending = [synth.synthesize_batch_async(h, fixed_duration=8)
                       for h in halves]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dispatch_s = time.perf_counter() - t0
    pcms = [p.pcm.cpu().numpy() for p in pending]
    wall_s = time.perf_counter() - t0
    launches = _launch_counts(kernels)
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    if syncs or launches["stft_forward"] != len(halves) or not all(
            bool(p.finite) for p in pending):
        raise AssertionError(f"pipelined batches: launches {launches}, "
                             f"synchronizing operations {syncs}")
    synth.generator.set_state(state)
    for half, p, pcm in zip(halves, pending, pcms):
        for i, want in enumerate(synth.synthesize_batch(half,
                                                        fixed_duration=8)):
            got = pcm[i, : p.totals[i] * hop].astype(np.float32) / 32767.0
            if not np.array_equal(got, want):
                raise AssertionError(f"pipelined batch item {i}: not "
                                     f"synthesize_batch's audio")
    print(f"synthesize_batch_async: 2 batches of {len(halves[0])} "
          f"dispatched in {dispatch_s * 1e3:.1f} ms with no synchronizing "
          f"operation seen, read after {wall_s * 1e3:.1f} ms, each "
          f"bit-equal to synthesize_batch; launches {launches} [{card}]")
    return {"dispatch_s": dispatch_s, "wall_s": wall_s,
            "launches": launches}


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
    record["pipelined"] = pipelined_batches(synth, batch, hop, kernels, card)

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
    # ... and the same step with remat_flow off and on
    record["remat"] = remat_path(device, card, kernels)

    # 6. the training runtime: dataset on disk, steps fed by the epoch
    # iterator, checkpoint and resume, the artifact and speech from it
    record["runtime"] = runtime_path(mc, device, card, kernels,
                                     train["median_s"] * 1e3)

    # 7. the training chain through CLI train, then convert and speak; 8.
    # from a book's text to a voice, speak --text on the chain's artifact
    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifact_") as keep:
        artifact, data = Path(keep) / "chain_artifact", Path(keep) / "data"
        book_data = Path(keep) / "book_data"
        record["chain"] = chain_path(device, card, kernels, artifact, data)
        record["book"] = book_path(card, kernels, artifact, book_data)
        # 9. interop and the joint stage: import-torch, train --stage joint
        # --init-torch on phase 7's dataset, CLI test
        record["interop"] = interop_path(device, card, kernels, data,
                                         train["launches_per_step"])
        # 10. the experimental stages on phase 7's dataset, each through
        # CLI train on seeded weight files of its frozen nets
        record["experimental"] = experimental_path(device, card, kernels,
                                                   data)
        # 11. the ringformer head (the STFT's DFT path), data-parallel
        # training and the MPD
        record["ringformer"] = ringformer_path(device, card, kernels, data,
                                               flush)
        # 12. RMVPE pitch on phase 8's book dataset (the STFT at
        # 1024/160/1024, B = 1), and the five conversion scripts
        record["rmvpe"] = rmvpe_path(device, card, kernels, book_data, flush)
        # 13. the root tools: pitch_eval on the card and the CPU, g2p_eval
        # and train_homographs on the host
        record["tools"] = tools_path(card, Path(keep))

    # 14. results: each kernel's own numbers and its launches on the path
    # that runs it: per train step (acoustic, and joint, the experimental
    # runs and the ringformer step beside it), or per probe run; the STFT's
    # DFT path as an entry of its own, at the ringformer step, and its
    # RMVPE shape (1024/160/1024, B = 1) too, per file
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
    remat_launches = {k: n // record["remat"]["steps"] for k, n in
                      record["remat"]["on"]["launches"].items()}
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
            # per remat_flow train step (phase 5's step, the flag on)
            "remat_launches": remat_launches.get(k.name),
            # per train step of each experimental run
            "experimental_launches": {run: n.get(k.name) for run, n in
                                      experimental.items()},
            "max_abs_err": n["max_abs_err"], "ms": n["ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n["bound_by"], "library_ms": n["library_ms"],
            "device_ms": n["device_ms"],  # torch.profiler
            "library_device_ms": n["library_device_ms"],
        })
    ring = record["ringformer"]
    entries[0]["ringformer_launches"] = {
        "all": ring["launches_per_step"]["train"]["stft_forward"],
        "dft_path": ring["launches_per_step"]["train"]["stft_dft"]}
    n = ring["dft"]
    entries.insert(1, {
        "name": "stft_forward_dft", "route": stft_forward.route,
        "source": stft_forward.source, "replaces": stft_forward.replaces,
        "launches": ring["launches_per_step"]["train"]["stft_dft"],
        "per": "ringformer train step", "n_fft": RING_N_FFT,
        "max_abs_err": n["max_abs_err"], "ms": n["ms"],
        "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
        "bound_by": n["bound_by"], "library_ms": n["library_ms"],
        "device_ms": n["device_ms"],
        "library_device_ms": n["library_device_ms"]})
    rmvpe = record["rmvpe"]
    entries[0]["rmvpe_launches"] = rmvpe["launches_per_file"]  # per file
    n = rmvpe["stft"]
    entries.insert(2, {
        "name": "stft_forward_rmvpe", "route": stft_forward.route,
        "source": stft_forward.source, "replaces": stft_forward.replaces,
        "launches": rmvpe["launches_per_file"], "per": "RMVPE pitch file",
        "n_fft": n["n_fft"], "hop": n["hop"], "shape": n["shape"],
        "max_abs_err": n["max_abs_err"], "ms": n["ms"],
        "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
        "bound_by": n["bound_by"], "library_ms": n["library_ms"],
        "device_ms": n["device_ms"],
        "library_device_ms": n["library_device_ms"]})
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

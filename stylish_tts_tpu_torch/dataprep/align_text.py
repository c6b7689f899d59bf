"""Alignment precache: trained aligner -> per-segment durations,
boundary-shift probabilities and confidence scores (the JAX package's
``dataprep/align_text.py``).

Per segment: normalised 80-bin mel (through the STFT kernel) -> the
aligner's CTC log-probs -> Viterbi forced alignment (``ops/ctc.py``) ->
a [3, T] record (durations, left-shift prob, right-shift prob) in
``alignment.safetensors``, plus ``scores_{val,train}.txt``.  The
frame -> token map comes from the lattice states (token k owns its
emission frames and the blanks after them).  Segments are bucketed on
coarse frame x text grids from their WAV headers and run in batches of a
fixed BATCH rows (short batches cycle their rows), so the device meets few
shapes.

Only the aligner's parameters are loaded from
``alignment_model.safetensors``: its batch norms keep their initial stats
(mean 0, variance 1), not the trained running stats, as the JAX package
does (ROADMAP Queue 3 watches this in the reference).
"""

from __future__ import annotations

import json
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..data.audio import read_wav, wav_info
from ..data.dataset import get_data_path_list
from ..device import resolve_device
from ..models.text_aligner import build_text_aligner, load_aligner_params
from ..ops.ctc import forced_align
from ..ops.mel import MelSpectrogram
from ..text import TextCleaner
from ..utils.tensorfile import write_safetensors

logger = logging.getLogger(__name__)

# frame and text bucket grids and the rows of a batch
FRAME_GRID, TEXT_GRID, BATCH = 200, 128, 16


def states_to_durations(states: np.ndarray, n_tokens: int) -> np.ndarray:
    """Lattice states [T_frames] -> per-token frame counts [n_tokens].

    Odd state 2k+1 emits token k; even state 2k is the blank following
    token k-1 (leading blanks go to token 0)."""
    tok = np.where(
        states % 2 == 1, (states - 1) // 2, np.maximum(states // 2 - 1, 0)
    )
    return np.bincount(tok, minlength=n_tokens)[:n_tokens]


def boundary_probs(
    log_probs: np.ndarray, text: np.ndarray, durations: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Left/right ±1-frame boundary shift probabilities."""
    n = durations.shape[0]
    left = np.zeros(n, np.float32)
    right = np.zeros(n, np.float32)
    index = 0
    for i in range(n - 1):
        index += int(durations[i])
        lt = int(text[i])
        rt = int(text[i + 1])
        lp = math.exp(log_probs[index - 1, lt] + log_probs[index, lt])
        sp = math.exp(log_probs[index - 1, lt] + log_probs[index, rt])
        rp = math.exp(log_probs[index - 1, rt] + log_probs[index, rt])
        denom = lp + sp + rp
        if denom > 0:
            left[i] = lp / denom
            right[i] = rp / denom
    return left, right


def align_text(config: Config, model_config: ModelConfig, device=None
               ) -> Dict[str, np.ndarray]:
    """Write ``alignment.safetensors`` and the score files of the dataset
    of ``config`` from its ``alignment_model.safetensors``; returns the
    records.  Runs on ``device`` (the card unless named)."""
    device = resolve_device(device)
    root = Path(config.dataset.path)
    wavdir = root / config.dataset.wav_path
    mc = model_config

    norm_mean, norm_std = -4.0, 4.0
    stats_path = root / "normalization.json"
    if stats_path.is_file():
        data = json.loads(stats_path.read_text())
        norm_mean = float(data.get("mel_log_mean", -4.0))
        norm_std = float(data.get("mel_log_std", 4.0))

    aligner = load_aligner_params(root / config.dataset.alignment_model_path,
                                  build_text_aligner(mc), device)
    to_mel = MelSpectrogram(
        n_mels=80, n_fft=mc.n_fft, win_length=mc.win_length,
        hop_length=mc.hop_length, sample_rate=mc.sample_rate,
    )
    text_cleaner = TextCleaner(mc.symbol)
    blank = mc.text_encoder.tokens

    @torch.no_grad()
    def run(waves, texts, text_lengths, mel_lengths):
        mel = to_mel(waves)
        mel = (torch.log(1e-5 + mel) - norm_mean) / norm_std
        mel = mel[:, :-1]  # the reference's preprocess drops the last frame
        log_probs, _ = aligner(mel, mel_lengths)
        _, scores, states = forced_align(
            log_probs, texts, mel_lengths, text_lengths, blank,
            return_states=True,
        )
        return log_probs, scores, states

    hop = mc.hop_length
    result: Dict[str, np.ndarray] = {}
    pool = ThreadPoolExecutor(8)
    for split, scores_name in (
        (config.dataset.val_data, "scores_val.txt"),
        (config.dataset.train_data, "scores_train.txt"),
    ):
        scores_map: Dict[str, float] = {}
        lines = get_data_path_list(root / split)
        entries = []  # (order, name, ids, fbucket, tbucket)
        for i, line in enumerate(lines):
            fields = line.strip().split("|")
            if len(fields) != 4:
                continue
            name, phonemes = fields[0], fields[1]
            ids = np.asarray(text_cleaner("$" + phonemes + "$"), np.int32)
            info = wav_info(wavdir / name)
            est_len = info.frames * mc.sample_rate // info.samplerate
            frames = est_len // hop
            fbucket = max(
                FRAME_GRID, -(-(frames + 2) // FRAME_GRID) * FRAME_GRID
            )
            tbucket = max(TEXT_GRID, -(-len(ids) // TEXT_GRID) * TEXT_GRID)
            entries.append((i, name, ids, fbucket, tbucket))

        groups: Dict[tuple, list] = {}
        for e in entries:
            groups.setdefault((e[3], e[4]), []).append(e)

        for (fbucket, tbucket), members in sorted(groups.items()):
            for g in range(0, len(members), BATCH):
                chunk = members[g : g + BATCH]
                waves = list(pool.map(
                    lambda e: read_wav(wavdir / e[1], mc.sample_rate), chunk))
                # BATCH rows, the chunk's cycled
                n_real = len(chunk)
                wave_len = fbucket * hop
                wbatch = np.zeros((BATCH, wave_len), np.float32)
                tbatch = np.zeros((BATCH, tbucket), np.int32)
                tlen = np.ones(BATCH, np.int32)
                mlen = np.full(BATCH, FRAME_GRID, np.int32)
                for j in range(BATCH):
                    e = chunk[j % n_real]
                    w = waves[j % n_real]
                    n = min(w.shape[0], wave_len)
                    wbatch[j, :n] = w[:n]
                    tbatch[j, : e[2].shape[0]] = e[2]
                    tlen[j] = e[2].shape[0]
                    mlen[j] = min(n // hop, fbucket)
                log_probs, scores, states = (
                    t.cpu().numpy() for t in run(
                        *(torch.from_numpy(a).to(device)
                          for a in (wbatch, tbatch, tlen, mlen))))
                for j in range(n_real):
                    _, name, ids, _, _ = chunk[j]
                    n_frames = int(mlen[j])
                    durs = states_to_durations(states[j][:n_frames], len(ids))
                    left, right = boundary_probs(log_probs[j], ids, durs)
                    result[name] = np.stack(
                        [durs.astype(np.float32), left, right])
                    scores_map[name] = float(
                        np.exp(scores[j][:n_frames]).mean())
            logger.info(
                "%s: bucket (%d frames, %d tokens): %d segments", split,
                fbucket, tbucket, len(members),
            )
        with open(root / scores_name, "w") as f:
            # in the list's order
            for _, name, *_ in sorted(entries):
                if name in scores_map:
                    f.write(f"{scores_map[name]} {name}\n")
    pool.shutdown()

    write_safetensors(root / config.dataset.alignment_path, result)
    logger.info(
        "wrote %s (%d segments)", config.dataset.alignment_path, len(result)
    )
    return result

"""Dataset: file-list parsing, precached pitch/alignment, time-binned
bucketing, per-segment loading with center padding.

Capability parity with FilePathDataset (train/dataloader.py:20-182):
  * ``file|phonemes|speaker|text`` list lines, hard validation
    (≤510 phonemes, ≥0.25 s audio);
  * entire pitch + alignment safetensors preloaded to RAM;
  * per-class duration weights from the alignment cache;
  * time bins of 20 frames (0.25 s @ hop 300) probed from WAV headers
    without decoding; audio center-padded to the bin's frame count.

Each (frame_count, text bucket) pair is one batch shape: bins keep the
number of shapes a run meets small.
"""

from __future__ import annotations

import logging
import os.path as osp
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..duration import DUR_TO_CLASS
from ..text import TextCleaner
from ..utils.tensorfile import read_safetensors
from .audio import read_wav, wav_info

logger = logging.getLogger(__name__)

MAX_PHONEMES = 510
TEXT_BUCKET = 64  # text lengths padded up to a multiple of this


def get_time_bin(sample_count: int, hop_length: int) -> int:
    frames = sample_count // hop_length
    if frames >= 20:
        return (frames - 20) // 20
    return -1


def get_frame_count(bin_num: int) -> int:
    return bin_num * 20 + 60


def text_bucket_length(n: int) -> int:
    return int(min(max(TEXT_BUCKET, -(-n // TEXT_BUCKET) * TEXT_BUCKET), 512))


@dataclass
class Segment:
    wav_path: str
    phonemes: str
    speaker: int
    raw_text: str


class FilePathDataset:
    def __init__(
        self,
        *,
        data_list: List[str],
        root_path: str | Path,
        text_cleaner: TextCleaner,
        model_config: ModelConfig,
        pitch_path: Optional[str] = None,
        alignment_path: Optional[str] = None,
    ):
        self.root_path = Path(root_path)
        self.text_cleaner = text_cleaner
        self.model_config = model_config
        self.sample_rate = model_config.sample_rate
        self.hop_length = model_config.hop_length

        self.pitch: Dict[str, np.ndarray] = {}
        if pitch_path and osp.isfile(pitch_path):
            self.pitch = {
                k: np.nan_to_num(v)
                for k, v in read_safetensors(pitch_path).items()
            }

        self.alignment: Dict[str, np.ndarray] = {}
        durations = np.zeros(16)
        if alignment_path and osp.isfile(alignment_path):
            self.alignment = read_safetensors(alignment_path)
            for align in self.alignment.values():
                dur = DUR_TO_CLASS[
                    np.clip(align[0].astype(np.int64), 1, 50)
                ]
                durations += np.bincount(dur, minlength=16)
        if durations.sum() > 0:
            self.duration_weights = (
                durations.sum() / np.maximum(durations * 16, 1e-9)
            ).astype(np.float32)
        else:
            self.duration_weights = np.ones(16, np.float32)

        self.segments: List[Segment] = []
        for line in data_list:
            line = line.strip()
            if not line:
                continue
            fields = line.split("|")
            if len(fields) != 4:
                raise ValueError(
                    f"Dataset lines must have 4 |-delimited fields: {line!r}"
                )
            self.segments.append(
                Segment(fields[0], fields[1], int(fields[2]), fields[3])
            )

    def __len__(self) -> int:
        return len(self.segments)

    # -- bucketing -------------------------------------------------------- #

    def time_bins(self) -> Tuple[Dict[int, List[int]], Dict[int, float]]:
        bins: Dict[int, List[int]] = {}
        seconds_per_bin: Dict[int, float] = {}
        total_seconds = 0.0
        for i, seg in enumerate(self.segments):
            info = wav_info(self.root_path / seg.wav_path)
            frames = info.frames
            if info.samplerate != self.sample_rate:
                frames = int(frames * self.sample_rate / info.samplerate)
            total_seconds += frames / self.sample_rate
            bin_num = get_time_bin(frames, self.hop_length)
            phonemes = seg.phonemes
            if bin_num == -1:
                raise ValueError(
                    f"Segment too short (<0.25 s): {seg.wav_path}"
                )
            if len(phonemes) < 1:
                raise ValueError(f"Segment has no phonemes: {seg.wav_path}")
            if len(phonemes) > MAX_PHONEMES:
                raise ValueError(
                    f"Segment exceeds {MAX_PHONEMES} phonemes: {seg.wav_path}"
                )
            if get_frame_count(bin_num) < len(phonemes):
                raise ValueError(
                    f"Audio too short for phoneme count: {seg.wav_path}"
                )
            bins.setdefault(bin_num, []).append(i)
            seconds_per_bin[bin_num] = (
                seconds_per_bin.get(bin_num, 0.0) + frames / self.sample_rate
            )
        logger.info("Total audio: %.2f h", total_seconds / 3600.0)
        return bins, seconds_per_bin

    # -- item loading ----------------------------------------------------- #

    def load_item(self, idx: int) -> dict:
        seg = self.segments[idx]
        wave = read_wav(self.root_path / seg.wav_path, self.sample_rate)
        bin_num = get_time_bin(wave.shape[0], self.hop_length)
        frame_count = get_frame_count(bin_num)
        pad_start = (frame_count * self.hop_length - wave.shape[0]) // 2
        pad_end = frame_count * self.hop_length - wave.shape[0] - pad_start
        wave = np.pad(wave, (pad_start, pad_end)).astype(np.float32)

        text = [0] + self.text_cleaner(seg.phonemes) + [0]
        text = np.asarray(text, dtype=np.int32)

        pitch = self.pitch.get(seg.wav_path)
        alignment = self.alignment.get(seg.wav_path)
        if alignment is None:
            alignment = np.zeros((3, text.shape[0]), np.float32)
        return dict(
            path=seg.wav_path,
            speaker=seg.speaker,
            text=text,
            wave=wave,
            pitch=pitch,
            alignment=alignment,
            frame_count=frame_count,
        )


def get_data_path_list(path: str | Path) -> List[str]:
    p = Path(path)
    if p.is_file():
        return p.read_text(encoding="utf-8", errors="ignore").splitlines()
    return []

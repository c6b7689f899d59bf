"""Host-side audio I/O: WAV header probe, decode, resample.

``wav_info`` reads only the RIFF chunk headers (PCM, float and extensible
formats alike), so a dataset is bucketed by length without decoding.
``read_wav`` decodes with ``scipy.io.wavfile`` and scales int16 by
1/32768, as the JAX package's native decoder does, so both give the same
floats.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


@dataclass
class WavInfo:
    frames: int
    samplerate: int
    channels: int


def wav_info(path: str | Path) -> WavInfo:
    with open(path, "rb") as f:
        riff, _, kind = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or kind != b"WAVE":
            raise ValueError(f"{path}: not a RIFF WAVE file")
        fmt = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: no data chunk")
            chunk, size = struct.unpack("<4sI", head)
            if chunk == b"fmt ":
                fmt = struct.unpack("<HHIIH", f.read(14))
                f.seek(size - 14 + size % 2, 1)
            elif chunk == b"data":
                if fmt is None:
                    raise ValueError(f"{path}: data before the fmt chunk")
                _, channels, rate, _, block_align = fmt
                return WavInfo(size // block_align, rate, channels)
            else:
                f.seek(size + size % 2, 1)


def read_wav(path: str | Path, target_sr: int) -> np.ndarray:
    """Decode to float32 mono (the first channel) at ``target_sr``."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data[:, 0]
    if sr != target_sr:
        g = math.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data

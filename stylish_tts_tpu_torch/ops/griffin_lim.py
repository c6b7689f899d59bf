"""Griffin-Lim mel inversion: the weight-free decoder that auditions the
CFM stage's predicted mels when no Vocos weights are given.

The normalised log-mel goes back to a linear spectrum through the
filterbank's pseudo-inverse, then ``n_iter`` Griffin-Lim iterations
alternate the iSTFT (``ops/stft.py:istft``) and the forward STFT
(``ops/stft_kernel.py:stft_forward``: the kernel on the card, its plain
version on the CPU).  The initial phase is uniform on [-pi, pi), drawn
from ``generator`` or handed in.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .mel import mel_filterbank
from .stft import istft
from .stft_kernel import stft_forward


@functools.lru_cache(maxsize=4)
def _pinv_fbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    fbank = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)
    return np.linalg.pinv(fbank).astype(np.float32)  # [mels, freq]


def mel_to_audio(
    norm_log_mel: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    win_length: int,
    hop_length: int,
    mean: float,
    std: float,
    n_iter: int = 32,
    generator: Optional[torch.Generator] = None,
    phase: Optional[torch.Tensor] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """Normalised log-mel [B, T, n_mels] -> waveform [B, T * hop].
    ``power`` 2 is the model's mel (log(1e-5 + power mel)), 1 Vocos's
    (log magnitude mel)."""
    n_mels = norm_log_mel.shape[-1]
    eps = 1e-5 if power == 2.0 else 0.0
    lin_mel = torch.exp(norm_log_mel * std + mean) - eps
    pinv = torch.from_numpy(_pinv_fbank(sample_rate, n_fft, n_mels)).to(
        norm_log_mel.device)
    lin_spec = torch.clamp(torch.matmul(lin_mel, pinv), min=0.0)
    magnitude = torch.sqrt(lin_spec) if power == 2.0 else lin_spec
    length = norm_log_mel.shape[1] * hop_length
    if phase is None:
        phase = (torch.rand(magnitude.shape, generator=generator,
                            device=magnitude.device) * 2.0 - 1.0) * math.pi
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    angles = phase
    frames = magnitude.shape[1]
    for _ in range(n_iter):
        wave = istft(magnitude * torch.cos(angles),
                     magnitude * torch.sin(angles), length=length, **kw)
        re, im = stft_forward(wave.contiguous(), **kw)
        angles = torch.atan2(im[:, :frames], re[:, :frames] + 1e-12)
    return istft(magnitude * torch.cos(angles), magnitude * torch.sin(angles),
                 length=length, **kw)

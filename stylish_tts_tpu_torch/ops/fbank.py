"""Kaldi-compatible log-mel filterbank features (the semantics of
``torchaudio.compliance.kaldi.fbank``): the front end of the wespeaker
speaker net (``models/wespeaker.py``).

Snip-edges framing of 400-sample windows every 160 samples at 16 kHz,
per-frame DC removal, 0.97 pre-emphasis with Kaldi's edge rule, the Povey
window (Hann^0.85), zero-padding to a 512-point DFT (an f32 matmul on a
host-made basis), the Kaldi mel scale (1127 ln(1 + f/700), low cutoff
20 Hz), a log floored at the f32 epsilon, and cepstral mean normalisation
over time.  No kernel: the JAX package computes this outside Pallas too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FRAME_LEN = 400      # 25 ms at 16 kHz
FRAME_SHIFT = 160    # 10 ms
PADDED = 512         # the next power of two
PREEMPH = 0.97
EPS = 1.1920928955078125e-07  # the f32 epsilon: Kaldi's log floor


def _kaldi_mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def kaldi_mel_banks(n_mels: int = 80, sample_rate: int = 16000,
                    low_freq: float = 20.0, high_freq: float = 0.0
                    ) -> np.ndarray:
    """[PADDED // 2, n_mels] triangular filters on the Kaldi mel scale."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    n_bins = PADDED // 2
    mel_low, mel_high = _kaldi_mel(low_freq), _kaldi_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    bin_mels = _kaldi_mel(sample_rate / PADDED * np.arange(n_bins))
    left = mel_low + np.arange(n_mels) * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels[:, None] - left[None, :]) / mel_delta
    down = (right[None, :] - bin_mels[:, None]) / mel_delta
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


@functools.lru_cache(maxsize=2)
def _povey_window() -> np.ndarray:
    n = np.arange(FRAME_LEN, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (FRAME_LEN - 1))
    return (hann ** 0.85).astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_basis() -> np.ndarray:
    """[PADDED, 2 * (PADDED // 2 + 1)]: cos | sin of the DFT."""
    k = np.arange(PADDED // 2 + 1)
    n = np.arange(PADDED)
    ang = -2.0 * np.pi * np.outer(n, k) / PADDED
    return np.concatenate([np.cos(ang), np.sin(ang)],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, sample_rate: int, device: torch.device):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in (
        _povey_window(), _dft_basis(), kaldi_mel_banks(n_mels, sample_rate)))


def kaldi_fbank(wave: torch.Tensor, n_mels: int = 80,
                sample_rate: int = 16000, cmn: bool = True) -> torch.Tensor:
    """[B, T] 16 kHz -> [B, frames, n_mels] log-fbank (mean-normalised
    over the frames when ``cmn``)."""
    window, basis, banks = _tables(n_mels, sample_rate, wave.device)
    x = wave.float().unfold(1, FRAME_LEN, FRAME_SHIFT)  # [B, frames, 400]
    x = x - x.mean(dim=-1, keepdim=True)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x = (x - PREEMPH * prev) * window
    x = torch.nn.functional.pad(x, (0, PADDED - FRAME_LEN))
    spec = torch.matmul(x, basis)
    bins = PADDED // 2 + 1
    # Kaldi drops the Nyquist bin for the mel banks
    power = (spec[..., :bins] ** 2 + spec[..., bins:] ** 2)[..., :PADDED // 2]
    feats = torch.log(torch.clamp(torch.matmul(power, banks), min=EPS))
    if cmn:
        feats = feats - feats.mean(dim=1, keepdim=True)
    return feats

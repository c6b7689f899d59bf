"""Mel filterbanks and the log-mel frontend.

The HTK-scale, unnormalised filterbank of ``torchaudio``'s
``melscale_fbanks``, applied as an f32 matmul over the frequency axis of
the STFT power spectrum.  Spectrograms are channels-last ``[B, frames,
n_mels]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stft_kernel import stft_forward


def _hz_to_mel(freq) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz(mel) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None
                   ) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], HTK scale, no norm."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    fb.flags.writeable = False
    return fb


@functools.lru_cache(maxsize=32)
def fbank_on(n_freqs: int, n_mels: int, sample_rate: int,
             device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.array(mel_filterbank(n_freqs, n_mels, sample_rate))).to(device)


class MelSpectrogram:
    """Power mel spectrogram with center reflect padding:
    audio [B, T] -> [B, frames, n_mels]; ``power`` 1 gives the magnitude
    mel (Vocos's features)."""

    def __init__(self, *, n_mels: int, n_fft: int, win_length: int,
                 hop_length: int, sample_rate: int, power: float = 2.0):
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self.power = power

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        real, imag = stft_forward(audio, n_fft=self.n_fft,
                                  hop_length=self.hop_length,
                                  win_length=self.win_length)
        power_spec = real * real + imag * imag
        if self.power != 2.0:
            power_spec = torch.pow(torch.sqrt(power_spec), self.power)
        fbank = fbank_on(self.n_fft // 2 + 1, self.n_mels, self.sample_rate,
                         audio.device)
        return torch.matmul(power_spec, fbank)


def calculate_mel(audio: torch.Tensor, to_mel: MelSpectrogram, mean: float,
                  std: float):
    """Normalised log-mel trimmed to an even frame count:
    (mel [B, frames, n_mels], mel_length [B])."""
    mel = (torch.log(1e-5 + to_mel(audio)) - mean) / std
    frames = mel.shape[1] - mel.shape[1] % 2
    mel = mel[:, :frames]
    mel_length = torch.full((audio.shape[0],), frames, dtype=torch.int64,
                            device=audio.device)
    return mel, mel_length


def log_norm_energy(mel: torch.Tensor, mean: float, std: float
                    ) -> torch.Tensor:
    """Frame energy from normalised log-mel: sum over mels of
    exp(x * std + mean) ** 0.33.  mel is [B, T, n_mels]."""
    return torch.pow(torch.exp(mel * std + mean), 0.33).sum(dim=-1)

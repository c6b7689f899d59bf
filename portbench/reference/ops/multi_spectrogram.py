"""Three-resolution spectrogram bundle feeding the spectral losses and the
MRD discriminator.

For each resolution:
  * ``mag``   log1p of a 128-mel-scaled amplitude spectrogram [B, T, 128]
  * ``phase`` phase, zero where |S| <= 1e-3                     [B, T, F]
  * ``fft``   the raw amplitude |S| as a [B, F, T, 1] image

The target side carries no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .mel import fbank_on
from .stft_kernel import stft_forward


@dataclass(frozen=True)
class Resolution:
    fft: int
    hop: int
    window: int


RESOLUTIONS = (
    Resolution(512, 50, 240),
    Resolution(1024, 120, 600),
    Resolution(2048, 240, 1200),
)


class MultiSpectrogram:
    def __init__(self, sample_rate: int, resolutions=RESOLUTIONS):
        self.sample_rate = sample_rate
        self.resolutions = resolutions

    def single(self, audio: torch.Tensor, index: int):
        r = self.resolutions[index]
        real, imag = stft_forward(audio, n_fft=r.fft, hop_length=r.hop,
                                  win_length=r.window)
        fft_mag = torch.sqrt(real * real + imag * imag + 1e-14)
        voiced = fft_mag.detach() > 1e-3
        # guard both branches: atan2's gradient at (~0, ~0) is inf, and
        # torch.where still differentiates the masked branch (NaN * 0 = NaN)
        one = torch.ones((), dtype=real.dtype, device=real.device)
        phase = torch.where(
            voiced,
            torch.atan2(torch.where(voiced, imag, one),
                        torch.where(voiced, real, one)),
            0.0,
        )
        fbank = fbank_on(r.fft // 2 + 1, 128, self.sample_rate, audio.device)
        mag = torch.log1p(torch.matmul(fft_mag, fbank))
        fft_img = fft_mag.transpose(1, 2)[..., None]  # [B, F, T, 1]
        return mag, phase, fft_img

    def __call__(self, *, target: torch.Tensor, pred: torch.Tensor):
        t_mag, t_phase, t_fft = [], [], []
        p_mag, p_phase, p_fft = [], [], []
        for i in range(len(self.resolutions)):
            with torch.no_grad():
                m, ph, f = self.single(target, i)
            t_mag.append(m)
            t_phase.append(ph)
            t_fft.append(f)
            m, ph, f = self.single(pred, i)
            p_mag.append(m)
            p_phase.append(ph)
            p_fft.append(f)
        return t_mag, p_mag, t_phase, p_phase, t_fft, p_fft

"""Vocos mel vocoder (the architecture of charactr/vocos-mel-24khz): the
frozen decoder that auditions the CFM stage's predicted Vocos-space mels
when ``training.vocos_weights`` names converted weights.

* features (``vocos_mel``, weight-free): 100-bin magnitude (power 1) mel
  at n_fft 1024 / hop 256 / win 1024, log clipped at 1e-7, on the STFT
  kernel;
* backbone: conv embed (k7) -> LayerNorm -> 8 ConvNeXt-v1 blocks (dim 512,
  intermediate 1536, layer scale, no GRN) -> final LayerNorm;
* head: Linear to n_fft + 2, log-magnitude (exp, clipped at 1e2) and
  phase, then the f32 iSTFT.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mel import MelSpectrogram
from ..ops.stft import istft
from .norms import Conv1d

VOCOS_SAMPLE_RATE = 24000
VOCOS_N_FFT = 1024
VOCOS_HOP = 256
VOCOS_N_MELS = 100


def vocos_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, frames, 100] log magnitude mel."""
    to_mel = MelSpectrogram(n_mels=VOCOS_N_MELS, n_fft=VOCOS_N_FFT,
                            win_length=VOCOS_N_FFT, hop_length=VOCOS_HOP,
                            sample_rate=VOCOS_SAMPLE_RATE, power=1.0)
    return torch.log(torch.clamp(to_mel(audio), min=1e-7))


class VocosConvNeXtBlock(nn.Module):
    """dwconv k7 -> LayerNorm -> Linear -> GELU -> Linear -> gamma * ->
    residual."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x))
        h = self.pwconv2(F.gelu(self.pwconv1(h), approximate="none"))
        return x + self.gamma * h


class Vocos(nn.Module):
    """log mel [B, T, n_mels] -> audio [B, (T - 1) * hop]."""

    def __init__(self, n_mels: int = VOCOS_N_MELS, dim: int = 512,
                 intermediate_dim: int = 1536, n_layers: int = 8,
                 n_fft: int = VOCOS_N_FFT, hop_length: int = VOCOS_HOP):
        super().__init__()
        self.n_layers, self.n_fft, self.hop_length = n_layers, n_fft, \
            hop_length
        self.embed = Conv1d(n_mels, dim, 7)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        for i in range(n_layers):
            setattr(self, f"convnext_{i}",
                    VocosConvNeXtBlock(dim, intermediate_dim))
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.embed(mel))
        for i in range(self.n_layers):
            x = getattr(self, f"convnext_{i}")(x)
        x = self.out(self.final_layer_norm(x)).float()
        freq = self.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(x[..., :freq]), max=1e2)
        phase = x[..., freq:]
        return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                     n_fft=self.n_fft, hop_length=self.hop_length,
                     win_length=self.n_fft)

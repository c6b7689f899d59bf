"""The frozen feature nets of the experimental hubert/CFM stages.

``AdaptiveHubert``: waveform -> HuBERT-base features (the SLM encoder with
plain attention, then ``final_proj``) nearest-interpolated to the mel frame
count.  ``SpeakerEmbeddingModel``: a 4-second crop -> Kaldi fbank -> the
SimAM-ResNet34 ASP speaker vector, mapped by ``proj`` where its natural
width is not ``hidden_dim``.  Both are frozen: they run in f32 under
``no_grad`` and are never saved in the train state.  Their weights come
from a seed or from converted files (``train/init.py:init_ssl``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fbank import kaldi_fbank
from ..ops.resample import resample
from .slm import SLMFeatureExtractor
from .wespeaker import SimAMResNet34ASP


class AdaptiveHubert(nn.Module):
    """[B, T] waveform -> [B, time_dim, proj_dim]."""

    def __init__(self, model_sr: int = 24000, hubert_sr: int = 16000,
                 hidden_dim: int = 768, proj_dim: int = 256,
                 n_layers: int = 6):
        super().__init__()
        self.model_sr, self.hubert_sr = model_sr, hubert_sr
        self.encoder = SLMFeatureExtractor(hidden_dim=hidden_dim,
                                           n_layers=n_layers,
                                           rel_pos_bias=False)
        self.final_proj = nn.Linear(hidden_dim, proj_dim)

    def forward(self, wave: torch.Tensor, time_dim: int) -> torch.Tensor:
        wave16 = resample(wave, self.model_sr, self.hubert_sr)
        x = self.final_proj(self.encoder(wave16)[-1])
        src = x.shape[1]
        # nearest interpolation to the mel frame count
        idx = torch.clamp(torch.arange(time_dim, device=x.device) * src
                          // time_dim, 0, src - 1)
        return x[:, idx]


class SpeakerEmbeddingModel(nn.Module):
    """[B, T] waveform -> [B, hidden_dim] utterance speaker vector."""

    def __init__(self, model_sr: int = 24000, embed_sr: int = 16000,
                 n_mels: int = 80, hidden_dim: int = 10240,
                 max_half_seconds: float = 2.0, m_channels: int = 64):
        super().__init__()
        self.model_sr, self.embed_sr, self.n_mels = model_sr, embed_sr, n_mels
        self.max_len = int(2 * max_half_seconds * embed_sr)
        self.xvector = SimAMResNet34ASP(m_channels, n_mels)
        natural = SimAMResNet34ASP.out_dim(m_channels, n_mels)
        self.proj = (nn.Linear(natural, hidden_dim) if natural != hidden_dim
                     else None)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        wave16 = resample(wave, self.model_sr, self.embed_sr)[:, :self.max_len]
        emb = self.xvector(kaldi_fbank(wave16, self.n_mels))
        return self.proj(emb) if self.proj is not None else emb

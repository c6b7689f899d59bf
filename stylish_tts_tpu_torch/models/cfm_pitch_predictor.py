"""CFM pitch predictor: a ConvNeXt regressor over the frozen HuBERT
features, conditioned on a mel style encoder's speaker vector; it predicts
the log2 z-scored F0 [B, T]."""

from __future__ import annotations

import torch
from torch import nn

from .convnext import StyleConvNeXtBlock
from .norms import Conv1x1
from .style_encoders import MelStyleEncoder
from .xut import mish


class CfmPitchPredictor(nn.Module):
    def __init__(self, asr_dim: int = 256, n_mels: int = 80,
                 hidden_dim: int = 256):
        super().__init__()
        self.asr_emb1 = Conv1x1(asr_dim, hidden_dim * 4)
        self.asr_emb2 = Conv1x1(hidden_dim * 4, hidden_dim)
        self.spk_emb = MelStyleEncoder(
            style_dim=hidden_dim, dim_in=n_mels, max_conv_dim=hidden_dim * 4,
            skip_last_downsample=True)
        for i in range(4):
            setattr(self, f"block_{i}", StyleConvNeXtBlock(
                hidden_dim, hidden_dim * 4, hidden_dim))
        self.out_proj = Conv1x1(hidden_dim, 1)

    def forward(self, asr: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """asr [B, T, asr_dim], mel [B, T_mel, n_mels] -> [B, T]."""
        x = self.asr_emb2(mish(self.asr_emb1(asr)))
        spk = self.spk_emb(mel)
        for i in range(4):
            x = getattr(self, f"block_{i}")(x, spk)
        return self.out_proj(x)[..., 0]

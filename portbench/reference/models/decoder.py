"""Acoustic decoder: AdaIN residual stack re-concatenating
[x, asr_res, F0, N] at every block."""

from __future__ import annotations

import torch
from torch import nn

from .norms import AdaptiveDecoderBlock, Conv1d, Conv1x1


class Decoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 512,
                 residual_dim: int = 64, style_dim: int = 64):
        super().__init__()
        self.f0_conv = Conv1d(1, 1, 3)
        self.n_conv = Conv1d(1, 1, 3)
        self.encode = AdaptiveDecoderBlock(in_dim + 2, hidden_dim, style_dim)
        self.asr_res = Conv1x1(in_dim, residual_dim)
        for i in range(4):
            setattr(self, f"decode_{i}", AdaptiveDecoderBlock(
                hidden_dim + residual_dim + 2, hidden_dim, style_dim))

    def forward(
        self,
        asr: torch.Tensor,       # [B, F, in_dim] aligned token encodings
        f0_curve: torch.Tensor,  # [B, F]
        energy: torch.Tensor,    # [B, F]
        style: torch.Tensor,     # [B, S]
    ) -> torch.Tensor:
        f0 = self.f0_conv(f0_curve[..., None])
        n = self.n_conv(energy[..., None])
        x = self.encode(torch.cat([asr, f0, n], dim=-1), style)
        asr_res = self.asr_res(asr)
        for i in range(4):
            x = torch.cat([x, asr_res, f0, n], dim=-1)
            x = getattr(self, f"decode_{i}")(x, style)
        return x  # [B, F, hidden_dim]

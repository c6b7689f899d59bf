"""Pitch/energy predictor with banded monotonic cross-attention.

A ProsodyEncoder over token states, frame queries formed by
``prosody @ alignment``, cross attention restricted to a ±window band around
each frame's aligned token, then 3 AdaIN residual blocks + 1×1 heads each
for F0 and energy.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .norms import (AdaptiveDecoderBlock, AdaptiveLayerNorm, Conv1d, Conv1x1,
                    sequence_mask)
from .prosody_encoder import ProsodyEncoder
from .text_encoder import MultiHeadAttention


def build_monotonic_band_mask(
    alignment: torch.Tensor, text_valid: torch.Tensor, window: int,
    reference_inverted: bool = False,
) -> torch.Tensor:
    """alignment [B, T, F], text_valid [B, T] -> allowed [B, 1, F, T].

    ``reference_inverted=True`` keeps the torch reference's inverted band
    (it attends to the band's complement plus padded keys), which models
    migrated from it were trained with."""
    tau = torch.argmax(alignment, dim=1)  # [B, F]
    t_idx = torch.arange(alignment.shape[1], device=alignment.device)
    tau_exp = tau[:, :, None]  # [B, F, 1]
    band = (t_idx >= tau_exp - window) & (t_idx <= tau_exp + window)
    valid = text_valid[:, None, :]
    if reference_inverted:
        allowed = ~band | ~valid
    else:
        allowed = band & valid
    return allowed[:, None]


class PitchEnergyPredictor(nn.Module):
    def __init__(self, mc: ModelConfig, cross_window: int = 5):
        super().__init__()
        self.cross_window = cross_window
        self.reference_band_mask = mc.pitch_energy_predictor.reference_band_mask
        pe_dim = mc.pitch_energy_predictor.inter_dim
        style_dim = mc.style_dim
        channels = pe_dim + style_dim
        dropout = mc.pitch_energy_predictor.dropout
        self.prosody_encoder = ProsodyEncoder(style_dim, pe_dim, 3,
                                              dropout=0.2)
        self.query_norm = AdaptiveLayerNorm(channels, style_dim)
        self.key_norm = AdaptiveLayerNorm(channels, style_dim)
        self.cross_attention = MultiHeadAttention(channels, channels, 8,
                                                  dropout)
        self.cross_post_dw = Conv1d(channels, channels, 5, groups=channels)
        self.cross_post_pw = Conv1x1(channels, channels)
        for head in ("f0", "energy"):
            for i in range(3):
                setattr(self, f"{head}_block_{i}", AdaptiveDecoderBlock(
                    channels, channels, style_dim, dropout))
            setattr(self, f"{head}_proj", Conv1x1(channels, 1))

    def forward(
        self,
        text_encoding: torch.Tensor,  # [B, T, pe_dim]
        text_lengths: torch.Tensor,   # [B]
        alignment: torch.Tensor,      # [B, T, F]
        style: torch.Tensor,          # [B, style_dim]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        prosody = self.prosody_encoder(text_encoding, style, text_lengths)
        base = torch.einsum("btc,btf->bfc", prosody, alignment)
        query = self.query_norm(base, style)
        key = self.key_norm(prosody, style)
        text_valid = sequence_mask(text_lengths, prosody.shape[1])
        allowed = build_monotonic_band_mask(
            alignment, text_valid, self.cross_window,
            reference_inverted=self.reference_band_mask,
        )
        attention = self.cross_attention(query, key, allowed)
        attention = F.silu(self.cross_post_dw(attention))
        attention = self.cross_post_pw(attention)
        x = (base + attention) / math.sqrt(2.0)  # [B, F, C]

        outputs = []
        for head in ("f0", "energy"):
            h = x
            for i in range(3):
                h = getattr(self, f"{head}_block_{i}")(h, style)
            outputs.append(getattr(self, f"{head}_proj")(h)[..., 0])
        f0, energy = outputs
        return f0, energy  # each [B, F]

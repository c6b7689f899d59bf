"""Duration predictor: own text encoder + text style encoder + prosody
encoder -> linear over the duration classes."""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .norms import Dropout
from .prosody_encoder import ProsodyEncoder
from .style_encoders import TextStyleEncoder
from .text_encoder import TextEncoder


def text_encoder_for(mc: ModelConfig, inter_dim: int) -> TextEncoder:
    tc = mc.text_encoder
    return TextEncoder(
        n_tokens=tc.tokens, hidden_dim=tc.hidden_dim,
        filter_channels=tc.filter_channels, n_heads=tc.heads,
        n_layers=tc.layers, kernel_size=tc.kernel_size, inter_dim=inter_dim,
        dropout=tc.dropout,
    )


class DurationPredictor(nn.Module):
    def __init__(self, mc: ModelConfig):
        super().__init__()
        self.text_encoder = text_encoder_for(mc, mc.inter_dim)
        self.style_encoder = TextStyleEncoder(
            mc.inter_dim, mc.style_dim, mc.style_encoder.layers)
        self.prosody_encoder = ProsodyEncoder(
            mc.style_dim, mc.inter_dim, mc.duration_predictor.n_layer,
            dropout=mc.duration_predictor.dropout)
        self.dropout = Dropout(mc.duration_predictor.last_dropout)
        self.duration_proj = nn.Linear(
            mc.inter_dim + mc.style_dim,
            mc.duration_predictor.duration_classes)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """-> class logits [B, T, classes]."""
        encoding, _, _ = self.text_encoder(tokens, lengths)
        style = self.style_encoder(encoding, lengths)
        prosody = self.prosody_encoder(encoding, style, lengths)
        return self.duration_proj(self.dropout(prosody))

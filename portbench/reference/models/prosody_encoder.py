"""Prosody encoder: transformer over [text-encoding ⊕ broadcast style] with
AdaLN conditioning; the style is re-concatenated after every layer's
projection back to d_model."""

from __future__ import annotations

import torch
from torch import nn

from .norms import AdaptiveLayerNorm, Conv1x1, Dropout, sequence_mask
from .text_encoder import ConvFFN, MultiHeadAttention, pair_mask


class ProsodyEncoder(nn.Module):
    def __init__(self, style_dim: int, d_model: int, n_layers: int,
                 dropout: float = 0.1, n_heads: int = 2,
                 kernel_size: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = Dropout(dropout)
        hidden = d_model + style_dim
        for i in range(n_layers):
            setattr(self, f"attn_{i}",
                    MultiHeadAttention(hidden, hidden, n_heads, dropout))
            setattr(self, f"norm1_{i}", AdaptiveLayerNorm(hidden, style_dim))
            setattr(self, f"ffn_{i}",
                    ConvFFN(hidden, hidden, hidden * 2, kernel_size, dropout))
            setattr(self, f"norm2_{i}", AdaptiveLayerNorm(hidden, style_dim))
            setattr(self, f"proj_{i}", Conv1x1(hidden, d_model))

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """x [B, T, d_model], style [B, S] -> [B, T, d_model + S]."""
        b, t, _ = x.shape
        mask = sequence_mask(lengths, t).to(x.dtype)[..., None]
        attn_mask = pair_mask(mask)
        style_seq = style[:, None, :].expand(b, t, style.shape[-1])
        x = torch.cat([x, style_seq], dim=-1)
        for i in range(self.n_layers):
            x = x * mask
            y = getattr(self, f"attn_{i}")(x, x, attn_mask)
            x = getattr(self, f"norm1_{i}")(x + self.dropout(y), style)
            y = getattr(self, f"ffn_{i}")(x, mask)
            x = getattr(self, f"norm2_{i}")(x + self.dropout(y), style)
            x = getattr(self, f"proj_{i}")(x)
            x = torch.cat([x, style_seq], dim=-1)
        return x * mask

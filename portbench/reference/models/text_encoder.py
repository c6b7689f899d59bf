"""Phoneme transformer encoder with rotary attention.

Token embedding ×√d, ConvReluNorm prenet, N transformer layers whose
attention applies RoPE (rotate-half) to the first ``head_dim//2//2*2``
dims of each head, conv-FFNs, and a projection to ``inter_dim``.  Masking
is an additive -1e4, as in the JAX package: a fully masked query row then
keeps its unmasked softmax instead of producing NaN.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .norms import ChannelLayerNorm, Conv1d, Conv1x1, Dropout, sequence_mask


def apply_rope(x: torch.Tensor, rope_dims: int) -> torch.Tensor:
    """Rotate the first ``rope_dims`` feature dims of ``x`` [B, H, T, Dh]
    as pairs (i, i + rope_dims/2)."""
    d = rope_dims
    half = d // 2
    x_rope, x_pass = x[..., :d], x[..., d:]
    t = x.shape[2]
    theta = 1.0 / (
        10000.0 ** (torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) * 2.0 / d)
    )
    angles = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * theta[None, :]
    angles = torch.cat([angles, angles], dim=-1)  # [T, d]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)


class MultiHeadAttention(nn.Module):
    """MHA with RoPE on half of each head's dims and an additive mask."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.channels = channels
        self.n_heads = n_heads
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, out_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attn_mask`` is bool [B, 1|H, Tq, Tk], True where allowed."""
        head_dim = self.channels // self.n_heads
        rope_dims = head_dim // 2 // 2 * 2

        def split_heads(h):
            b, t, _ = h.shape
            return h.reshape(b, t, self.n_heads, head_dim).transpose(1, 2)

        q = apply_rope(split_heads(self.q(x)), rope_dims)
        k = apply_rope(split_heads(self.k(context)), rope_dims)
        v = split_heads(self.v(context))
        # scores, softmax and the value sum in f32 (as the JAX package's
        # f32-accumulating einsums), the result in the activation type
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(head_dim)
        if attn_mask is not None:
            scores = scores + torch.where(attn_mask, 0.0, -1e4)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(probs, v.float()).to(v.dtype)
        b, _, t, _ = out.shape
        return self.out(out.transpose(1, 2).reshape(b, t, self.channels))


class ConvFFN(nn.Module):
    """conv k -> relu -> dropout -> conv k, masked."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.conv1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.dropout = Dropout(dropout)
        self.conv2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.dropout(F.relu(self.conv1(x * mask)))
        return self.conv2(x * mask) * mask


def pair_mask(mask: torch.Tensor) -> torch.Tensor:
    """mask [B, T, 1] float -> bool [B, 1, T, T] (query and key valid)."""
    valid = mask[:, None, :, 0] > 0  # [B, 1, T]
    return valid[:, :, None, :] & valid[:, :, :, None]


class TransformerEncoder(nn.Module):
    """(RoPE-MHA + conv-FFN) layers with channel LayerNorms."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = Dropout(dropout)
        for i in range(n_layers):
            setattr(self, f"attn_{i}", MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, dropout))
            setattr(self, f"norm1_{i}", ChannelLayerNorm(hidden_channels))
            setattr(self, f"ffn_{i}", ConvFFN(
                hidden_channels, hidden_channels, filter_channels,
                kernel_size, dropout))
            setattr(self, f"norm2_{i}", ChannelLayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        attn_mask = pair_mask(mask)
        for i in range(self.n_layers):
            x = x * mask
            y = getattr(self, f"attn_{i}")(x, x, attn_mask)
            x = getattr(self, f"norm1_{i}")(x + self.dropout(y))
            y = getattr(self, f"ffn_{i}")(x, mask)
            x = getattr(self, f"norm2_{i}")(x + self.dropout(y))
        return x * mask


class ConvReluNorm(nn.Module):
    """Prenet: n conv-norm-relu-dropout layers + residual 1x1 projection."""

    def __init__(self, hidden_channels: int, out_channels: int,
                 kernel_size: int = 5, n_layers: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = Dropout(dropout)
        for i in range(n_layers):
            setattr(self, f"conv_{i}", Conv1d(
                hidden_channels, hidden_channels, kernel_size))
            setattr(self, f"norm_{i}", ChannelLayerNorm(hidden_channels))
        self.proj = Conv1x1(hidden_channels, out_channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x_org = x
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x * mask)
            x = self.dropout(F.relu(getattr(self, f"norm_{i}")(x)))
        return (x_org + self.proj(x)) * mask


class TextEncoder(nn.Module):
    """tokens [B, T] -> (mu [B, T, inter_dim], hidden [B, T, C],
    mask [B, T, 1])."""

    def __init__(self, n_tokens: int, hidden_dim: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int,
                 inter_dim: int, dropout: float = 0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.emb = nn.Embedding(n_tokens, hidden_dim)
        self.prenet = ConvReluNorm(hidden_dim, hidden_dim)
        self.encoder = TransformerEncoder(
            hidden_dim, filter_channels, n_heads, n_layers, kernel_size,
            dropout)
        self.proj_m = Conv1x1(hidden_dim, inter_dim)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.emb(tokens) * math.sqrt(self.hidden_dim)
        mask = sequence_mask(lengths, tokens.shape[1]).to(x.dtype)[..., None]
        x = self.prenet(x, mask)
        x = self.encoder(x, mask)
        return self.proj_m(x) * mask, x, mask

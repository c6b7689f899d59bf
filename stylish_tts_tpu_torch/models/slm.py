"""Speech-language-model feature extractor of the 'slm' perceptual loss, at
the shape of WavLM-base:

  * conv feature encoder: 7 conv1d layers, strides (5,2,2,2,2,2,2), kernels
    (10,3,3,3,3,2,2), 512 channels, group norm after the first;
  * feature projection (layer norm + 512 -> 768 dense);
  * grouped positional conv (k=128, 16 groups);
  * ``n_layers`` post-norm transformer blocks with WavLM's gated
    relative-position-bias attention (320 log buckets, max distance 800;
    the bias table is shared by all layers).

It is frozen.  Its parameters come from a seed or from the JAX package's
flax tree through ``convert.load_flax_params``; no WavLM weights ship.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh

CONV_DIMS = (512,) * 7
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)
CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)


def relative_position_buckets(length: int, num_buckets: int = 320,
                              max_distance: int = 800,
                              device=None) -> torch.Tensor:
    """T5-style bidirectional log-bucketed relative positions [T, T]."""
    half = num_buckets // 2
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    buckets = (rel > 0).to(torch.int64) * half
    rel = torch.abs(rel)
    max_exact = half // 2
    large = max_exact + (
        torch.log(torch.clamp(rel, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact) * (half - max_exact)
    ).to(torch.int64)
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class _EncoderAttention(nn.Module):
    """softmax(q k^T / sqrt(d) + gate(x) * bias) v with a per-head,
    per-query gate projected from the layer input; without
    ``rel_pos_bias`` plain wav2vec2/HuBERT attention (no bias, no gate)."""

    def __init__(self, hidden_dim: int, n_heads: int,
                 rel_pos_bias: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = hidden_dim // n_heads
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        if rel_pos_bias:
            self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, 1, n_heads))
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]
                ) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.n_heads, self.head_dim
        q = self.q_proj(x).view(b, t, h, d) / math.sqrt(d)
        k = self.k_proj(x).view(b, t, h, d)
        v = self.v_proj(x).view(b, t, h, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if position_bias is not None:
            proj = self.gru_rel_pos_linear(x.view(b, t, h, d))
            gates = torch.sigmoid(proj.view(b, t, h, 2, 4).sum(-1))
            gate = gates[..., 0] * (
                gates[..., 1] * self.gru_rel_pos_const - 1.0) + 2.0  # [B,T,h]
            scores = scores + gate.permute(0, 2, 1)[..., None] \
                * position_bias[None].to(x.dtype)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out_proj(out.reshape(b, t, h * d))


class SLMFeatureExtractor(nn.Module):
    """[B, T] 16 kHz audio -> n_layers + 1 hidden states [B, F, 768].
    ``rel_pos_bias=False`` is the HuBERT-base encoder: the same layers with
    plain attention, no bias table."""

    def __init__(self, hidden_dim: int = 768, n_layers: int = 12,
                 n_heads: int = 12, intermediate_dim: int = 3072,
                 num_buckets: int = 320, max_distance: int = 800,
                 rel_pos_bias: bool = True):
        super().__init__()
        self.n_layers = n_layers
        self.rel_pos_bias = rel_pos_bias
        self.num_buckets, self.max_distance = num_buckets, max_distance
        c_in = 1
        for i, (c, k, s) in enumerate(zip(CONV_DIMS, CONV_KERNELS,
                                          CONV_STRIDES)):
            setattr(self, f"conv_{i}", nn.Conv1d(c_in, c, k, stride=s,
                                                 bias=False))
            c_in = c
        self.gn = nn.GroupNorm(CONV_DIMS[0], CONV_DIMS[0], eps=1e-5)
        self.fp_ln = nn.LayerNorm(CONV_DIMS[-1], eps=1e-5)
        self.feature_proj = nn.Linear(CONV_DIMS[-1], hidden_dim)
        self.pos_conv = nn.Conv1d(hidden_dim, hidden_dim, 128, padding=64,
                                  groups=16)
        self.encoder_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        if rel_pos_bias:
            self.rel_attn_embed = nn.Parameter(
                0.02 * torch.randn(num_buckets, n_heads))
        for i in range(n_layers):
            setattr(self, f"layer_{i}_attn",
                    _EncoderAttention(hidden_dim, n_heads, rel_pos_bias))
            setattr(self, f"layer_{i}_ln1", nn.LayerNorm(hidden_dim, eps=1e-5))
            setattr(self, f"layer_{i}_fc1",
                    nn.Linear(hidden_dim, intermediate_dim))
            setattr(self, f"layer_{i}_fc2",
                    nn.Linear(intermediate_dim, hidden_dim))
            setattr(self, f"layer_{i}_ln2", nn.LayerNorm(hidden_dim, eps=1e-5))

    def forward(self, audio16k: torch.Tensor) -> List[torch.Tensor]:
        x = audio16k[:, None, :]  # [B, 1, T]
        for i in range(len(CONV_DIMS)):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.gn(x)
            x = F.gelu(x)
        x = self.feature_proj(self.fp_ln(x.transpose(1, 2)))  # [B, F, C]
        pos = self.pos_conv(x.transpose(1, 2))[:, :, : x.shape[1]]
        x = self.encoder_ln(x + F.gelu(pos).transpose(1, 2))
        position_bias = None
        if self.rel_pos_bias:
            buckets = relative_position_buckets(
                x.shape[1], self.num_buckets, self.max_distance, x.device)
            position_bias = self.rel_attn_embed[buckets].permute(2, 0, 1)
        hidden_states = [x]
        for i in range(self.n_layers):
            y = getattr(self, f"layer_{i}_attn")(x, position_bias)
            x = getattr(self, f"layer_{i}_ln1")(x + y)
            y = getattr(self, f"layer_{i}_fc2")(
                F.gelu(getattr(self, f"layer_{i}_fc1")(x)))
            x = getattr(self, f"layer_{i}_ln2")(x + y)
            hidden_states.append(x)
        return hidden_states


def slm_feature_loss(gt_states: List[torch.Tensor],
                     pred_states: List[torch.Tensor]) -> torch.Tensor:
    """Mean L1 over all hidden states (of the global batch), in f32."""
    loss = 0.0
    for g, p in zip(gt_states, pred_states):
        loss = loss + mesh.mean(torch.abs(g.detach().float() - p.float()))
    return loss / len(gt_states)

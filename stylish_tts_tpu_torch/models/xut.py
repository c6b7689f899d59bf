"""XUT: the cross-U-transformer backbone of the CFM mel decoder.

A U of transformer blocks: ``depth`` levels of encoder blocks, then
``depth`` levels of decoder blocks whose first block cross-attends to the
final encoder output.  Each block pre-norms with AdaLN (RMSNorm, eps 1e-6,
modulated by (scale, shift) and gated by gate + 1, from the timestep
embedding or from modulations shared by all blocks), attends with learnable
per-head axial RoPE over a continuous position map, and ends in a packed
SwiGLU.  The modulated tensor replaces the residual stream before each
residual add, as in the reference.  Channels-last [B, T, C]; module names
follow the flax tree.  Attention is plain PyTorch (no Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Modulation = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class RMSNorm(nn.Module):
    """x / rms(x) * weight (flax ``scale``), eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight


class AxialRoPE(nn.Module):
    """Learnable log-frequency rotary embedding over a continuous position
    map.  x: [B, H, T, D]; pos: [B, T, pos_dim].  ``freqs`` [H, half,
    pos_dim] starts at linspace(log pi, log 5 pi, pos_dim)."""

    def __init__(self, head_dim: int, n_heads: int, pos_dim: int = 1):
        super().__init__()
        self.n_heads, self.pos_dim = n_heads, pos_dim
        half = head_dim // (2 * pos_dim)
        init = torch.linspace(math.log(math.pi), math.log(10.0 * math.pi / 2),
                              pos_dim)
        self.freqs = nn.Parameter(init.expand(n_heads, half, pos_dim).clone())

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        b, t = pos.shape[:2]
        f = pos[:, :, None, None, :] * torch.exp(self.freqs)[None, None]
        f = f.reshape(b, t, self.n_heads, -1)
        f = torch.repeat_interleave(f, 2, dim=-1).transpose(1, 2)
        rot = f.shape[-1]
        t_rot, t_right = x[..., :rot], x[..., rot:]
        x1, x2 = t_rot[..., 0::2], t_rot[..., 1::2]
        rot_half = torch.stack([-x2, x1], dim=-1).reshape(t_rot.shape)
        t_rot = t_rot * torch.cos(f) + rot_half * torch.sin(f)
        return torch.cat([t_rot, t_right], dim=-1)


class AdaLNModulation(nn.Module):
    """t_emb -> (scale, shift, gate), each [B, 1, dim]: LayerNorm ->
    Linear 4x -> Mish -> zero-initialised Linear 3x."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim * 3)

    def forward(self, t_emb: torch.Tensor) -> Modulation:
        h = self.fc2(mish(self.fc1(self.ln(t_emb))))
        return tuple(c[:, None] for c in h.chunk(3, dim=-1))


class AdaLN(nn.Module):
    """(RMSNorm(x) * (scale + 1) + shift, gate + 1), the modulation from
    ``adaln`` (a zero-initialised Linear of t_emb) or, with ``shared``,
    handed in."""

    def __init__(self, dim: int, shared: bool = False):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.adaln = None if shared else nn.Linear(dim, dim * 3)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                shared: Optional[Modulation] = None):
        if shared is None:
            scale, shift, gate = (c[:, None] for c in
                                  self.adaln(t_emb).chunk(3, dim=-1))
        else:
            scale, shift, gate = shared
        return self.norm(x) * (scale + 1.0) + shift, gate + 1.0


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, H, T, D] -> [B, T, H * D]."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    b, h, t, d = out.shape
    return out.transpose(1, 2).reshape(b, t, h * d)


class _SelfAttention(nn.Module):
    """Fused-qkv self attention with axial RoPE."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.rope = AxialRoPE(dim // heads, heads)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = (h.reshape(b, t, self.heads, -1).transpose(1, 2)
                   for h in self.qkv(x).chunk(3, dim=-1))
        if pos is not None:
            q, k = self.rope(q, pos), self.rope(k, pos)
        return self.out(_attend(q, k, v))


class _CrossAttention(nn.Module):
    """q / fused-kv cross attention with axial RoPE on both sides."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim, bias=False)
        self.kv = nn.Linear(dim, dim * 2, bias=False)
        self.rope = AxialRoPE(dim // heads, heads)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                pos: Optional[torch.Tensor] = None,
                ctx_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        s = ctx.shape[1]
        q = self.q(x).reshape(b, t, self.heads, -1).transpose(1, 2)
        k, v = (h.reshape(b, s, self.heads, -1).transpose(1, 2)
                for h in self.kv(ctx).chunk(2, dim=-1))
        if pos is not None:
            q = self.rope(q, pos)
        if ctx_pos is not None:
            k = self.rope(k, ctx_pos)
        return self.out(_attend(q, k, v))


class _SwiGLU(nn.Module):
    """Packed SwiGLU: w12 -> chunk -> silu(x1) * x2 -> w3."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.w12 = nn.Linear(dim, mlp_dim * 2)
        self.w3 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class XUTBlock(nn.Module):
    """AdaLN-pre-normed self attention (+ cross attention where
    ``cross``) and SwiGLU, each gated by gate + 1."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 cross: bool = False, shared: bool = False):
        super().__init__()
        self.cross = cross
        self.attn_pre_norm = AdaLN(dim, shared)
        self.attn = _SelfAttention(dim, heads)
        if cross:
            self.xattn_pre_norm = AdaLN(dim, shared)
            self.xattn = _CrossAttention(dim, heads)
        self.mlp_pre_norm = AdaLN(dim, shared)
        self.mlp = _SwiGLU(dim, mlp_dim)

    def forward(self, x, pos, t_emb, skip=None, skip_pos=None,
                shared_adaln=None):
        sh_attn, sh_xattn, sh_ffw = (shared_adaln if shared_adaln is not None
                                     else (None, None, None))
        x, gate = self.attn_pre_norm(x, t_emb, sh_attn)
        x = x + self.attn(x, pos) * gate
        if self.cross and skip is not None:
            x, gate = self.xattn_pre_norm(x, t_emb, sh_xattn)
            x = x + self.xattn(x, skip, pos, skip_pos) * gate
        x, gate = self.mlp_pre_norm(x, t_emb, sh_ffw)
        return x + self.mlp(x) * gate


class XUTBackbone(nn.Module):
    """``depth`` levels of ``enc_blocks`` blocks, then ``depth`` levels of
    ``dec_blocks`` blocks whose first cross-attends to the final encoder
    output."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, depth: int = 4,
                 enc_blocks: int = 1, dec_blocks: int = 2,
                 shared: bool = False):
        super().__init__()
        self.enc = [f"enc_{d}_{i}" for d in range(depth)
                    for i in range(enc_blocks)]
        self.dec = [(f"dec_{d}_{i}", i == 0) for d in range(depth)
                    for i in range(dec_blocks)]
        for name in self.enc:
            setattr(self, name, XUTBlock(dim, heads, mlp_dim, shared=shared))
        for name, cross in self.dec:
            setattr(self, name, XUTBlock(dim, heads, mlp_dim, cross=cross,
                                         shared=shared))

    def forward(self, x, pos, t_emb, shared_adaln=None):
        for name in self.enc:
            x = getattr(self, name)(x, pos, t_emb, shared_adaln=shared_adaln)
        enc_out = x
        for name, cross in self.dec:
            x = getattr(self, name)(x, pos, t_emb,
                                    skip=enc_out if cross else None,
                                    skip_pos=pos, shared_adaln=shared_adaln)
        return x


class TBackbone(nn.Module):
    """A plain stack of ``depth`` blocks (the TREAD pre/post routers)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, depth: int,
                 shared: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}",
                    XUTBlock(dim, heads, mlp_dim, shared=shared))

    def forward(self, x, pos, t_emb, shared_adaln=None):
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, pos, t_emb,
                                            shared_adaln=shared_adaln)
        return x


class TimestepEmbedding(nn.Module):
    """t [B] -> [B, dim]: cos | sin of 1000 t at exp-spaced frequencies,
    then one Linear and Mish."""

    def __init__(self, dim: int, max_period: float = 10000.0,
                 time_factor: float = 1000.0):
        super().__init__()
        self.dim, self.max_period, self.time_factor = \
            dim, max_period, time_factor
        self.proj = nn.Linear(2 * (dim // 2), dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(-math.log(self.max_period) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        args = self.time_factor * t[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return mish(self.proj(emb))

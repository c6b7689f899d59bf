"""Style-conditioned conformer of the ringformer generator head: blocks of
FF(½) -> MHSA -> depthwise-conv module -> FF(½), each behind an adaptive
layer norm on the style vector, and a post-norm.

Submodules carry the flax names (``block_{i}``, ``ff1``/``ff2`` with
``Dense_0``/``Dense_1``, ``attn`` with ``to_q``/``to_kv``/``to_out``,
``conv`` with ``norm``, ``pw_in``, ``dwconv``, ``bn``, ``pw_out``).  The
conv module's batch norm is flax's (``norms.FlaxBatchNorm``: momentum 0.9
on the running stats, the biased batch variance, eps 1e-5), with its
running stats as the buffers ``bn.mean``/``bn.var``.  Dropout rates are 0
and the sequence runs unmasked in the JAX package's use (the ringformer
head), so there is neither here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norms import AdaptiveLayerNorm, FlaxBatchNorm


class _FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim * mult)
        self.Dense_1 = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(x)))


class _Attention(nn.Module):
    """Multi-head self-attention; scores, softmax and the weighted sum in
    f32, the result cast back to the activation type."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)

        def heads(h):
            return h.reshape(b, t, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (self.dim_head ** -0.5)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v.float()).to(v.dtype)
        out = out.transpose(1, 2).reshape(b, t, -1)
        return self.to_out(out)


class _ConvModule(nn.Module):
    def __init__(self, dim: int, style_dim: int, expansion: int = 2,
                 kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion
        self.kernel_size = kernel_size
        self.norm = AdaptiveLayerNorm(dim, style_dim)
        self.pw_in = nn.Linear(dim, inner * 2)
        self.dwconv = nn.Conv1d(inner, inner, kernel_size, groups=inner)
        self.bn = FlaxBatchNorm(inner, affine=True)
        self.pw_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        a, gate = self.pw_in(self.norm(x, style)).chunk(2, dim=-1)
        x = a * torch.sigmoid(gate)  # GLU
        pad = self.kernel_size // 2
        h = F.pad(x.transpose(1, 2),
                  (pad, pad - (self.kernel_size + 1) % 2))
        x = self.bn(self.dwconv(h).transpose(1, 2))
        return self.pw_out(x * torch.sigmoid(x))  # Swish


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, style_dim: int):
        super().__init__()
        self.ff1_norm = AdaptiveLayerNorm(dim, style_dim)
        self.ff1 = _FeedForward(dim)
        self.attn_norm = AdaptiveLayerNorm(dim, style_dim)
        self.attn = _Attention(dim)
        self.conv = _ConvModule(dim, style_dim)
        self.ff2_norm = AdaptiveLayerNorm(dim, style_dim)
        self.ff2 = _FeedForward(dim)
        self.post_norm = AdaptiveLayerNorm(dim, style_dim)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        x_ff1 = 0.5 * self.ff1(self.ff1_norm(x, style)) + x
        x = self.attn(self.attn_norm(x, style)) + x_ff1
        x = self.conv(x, style) + x
        x = 0.5 * self.ff2(self.ff2_norm(x, style)) + x
        return self.post_norm(x, style)


class Conformer(nn.Module):
    """[B, T, dim] and style [B, S] -> [B, T, dim].  The batch norms use
    the batch's moments and move their running stats in train mode
    (``module.train()``), the running stats in eval mode."""

    def __init__(self, dim: int, depth: int, style_dim: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}", ConformerBlock(dim, style_dim))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, style)
        return x

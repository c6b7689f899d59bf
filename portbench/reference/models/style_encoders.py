"""Style encoders: text-side (ConvNeXt stack, masked mean-pool) and
mel-side (2-D CNN of spectral-norm convs; training only)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .convnext import BasicConvNeXtBlock
from .norms import Conv1d, sequence_mask


class TextStyleEncoder(nn.Module):
    """conv k7 -> N BasicConvNeXt blocks -> masked mean-pool -> [B, S]."""

    def __init__(self, in_dim: int, style_dim: int, n_layers: int = 2):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = Conv1d(in_dim, style_dim, 7)
        for i in range(n_layers):
            setattr(self, f"block_{i}",
                    BasicConvNeXtBlock(style_dim, style_dim * 4))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        mask = sequence_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
        return (x * mask).sum(dim=1) / lengths[:, None].to(x.dtype)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SpectralConv(nn.Module):
    """2-D conv on NCHW with flax's spectral normalisation: the kernel,
    viewed as [kh * kw * in, out] as flax lays it out, is divided by its
    largest singular value from one power-iteration step.  ``u`` [1, out]
    and ``sigma`` are the batch stats; ``update_stats=True`` stores the
    step's values.  The normalised kernel is f32 (flax promotes it against
    the f32 ``u``), so the conv runs in f32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, kernel_size,
                                groups=groups, bias=bias)
        self.register_buffer("u", torch.randn(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.Conv_0.weight
        out = w.shape[0]
        value = w.permute(2, 3, 1, 0).reshape(-1, out).float()
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ value.T)
            u0 = _l2_normalize(v0 @ value)
        sigma = (v0 @ value @ u0.T)[0, 0]
        if update_stats:
            self.u.copy_(u0)
            self.sigma.copy_(sigma.detach())
        value = value / torch.where(sigma != 0, sigma, 1.0)
        return value.reshape(w.shape[2], w.shape[3], w.shape[1], out) \
            .permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        bias = self.Conv_0.bias
        return F.conv2d(x.float(), self.normalized_weight(update_stats),
                        None if bias is None else bias.float(),
                        stride=self.stride, padding=self.padding,
                        groups=self.groups)


class _ResBlk2d(nn.Module):
    """Residual block with 'half' downsampling on NCHW [B, C, mels, T]."""

    def __init__(self, dim_in: int, dim_out: int, downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.conv1 = SpectralConv(dim_in, dim_in, (3, 3), padding=1)
        # torch-style symmetric (1, 1) padding before the stride-2 conv
        self.downconv = SpectralConv(
            dim_in, dim_in, (3, 3), stride=2, padding=1,
            groups=dim_in) if downsample else None
        self.conv2 = SpectralConv(dim_in, dim_out, (3, 3), padding=1)
        self.conv1x1 = SpectralConv(dim_in, dim_out, (1, 1), bias=False) \
            if dim_in != dim_out else None

    def _down(self, h: torch.Tensor) -> torch.Tensor:
        if not self.downsample:
            return h
        if h.shape[3] % 2:  # pad the time axis to even
            h = torch.cat([h, h[..., -1:]], dim=3)
        return F.avg_pool2d(h, 2)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        h = self.conv1(F.leaky_relu(x, 0.2), update_stats)
        if self.downsample:
            h = self.downconv(h, update_stats)
        h = self.conv2(F.leaky_relu(h, 0.2), update_stats)
        s = x
        if self.conv1x1 is not None:
            s = self.conv1x1(s, update_stats)
        s = self._down(s)
        h = h[:, :, : s.shape[2], : s.shape[3]]  # stride vs pool on odd sizes
        return (s + h) / math.sqrt(2.0)


class MelStyleEncoder(nn.Module):
    """mel [B, frames, n_mels] -> style [B, style_dim], a 2-D CNN over the
    [n_mels, frames] image."""

    def __init__(self, style_dim: int = 64, dim_in: int = 48,
                 max_conv_dim: int = 384, skip_last_downsample: bool = True):
        super().__init__()
        self.conv_in = SpectralConv(1, dim_in, (3, 3), padding=1)
        for i in range(4):
            dim_out = min(dim_in * 2, max_conv_dim)
            setattr(self, f"res_{i}", _ResBlk2d(
                dim_in, dim_out,
                downsample=not (i == 3 and skip_last_downsample)))
            dim_in = dim_out
        self.conv_out = SpectralConv(dim_in, dim_in, (5, 5))
        self.unshared = nn.Linear(dim_in, style_dim)

    def forward(self, mel: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        x = self.conv_in(mel.transpose(1, 2)[:, None], update_stats)
        for i in range(4):
            x = getattr(self, f"res_{i}")(x, update_stats)
        x = F.leaky_relu(x, 0.2)
        # edge-pad tiny inputs so the 5x5 valid conv never comes out empty
        pad_h, pad_w = max(0, 5 - x.shape[2]), max(0, 5 - x.shape[3])
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="replicate")
        x = self.conv_out(x, update_stats).mean(dim=(2, 3))
        x = F.leaky_relu(x, 0.2)
        return F.linear(x, self.unshared.weight.to(x.dtype),
                        self.unshared.bias.to(x.dtype))

"""Normalisation / conditioning primitives on channels-last [B, T, C].

Submodules and parameters carry the JAX package's flax names, including
flax's auto-names (``Conv_0`` inside ``Conv1d``, ``AdaptiveInstanceNorm_0/1``
inside ``AdaptiveDecoderBlock``, ``fc`` inside each adaptive norm), so
``convert.load_flax_params`` maps weights by name alone.

Dropout sits where the JAX package has ``nn.Dropout``.  It is active only in
train mode (``module.train()``) and draws its masks from the generator that
``set_dropout_generator`` gives it; ``build_models`` returns modules in eval
mode, so it is off outside training.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class Dropout(nn.Module):
    """Inverted dropout with flax's semantics: keep with probability
    1 - rate, scale kept values by 1 / (1 - rate).  Masks come from
    ``generator`` (the default generator when it is None)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0).to(x.dtype)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every Dropout inside ``module`` draws from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class FlaxBatchNorm(nn.Module):
    """flax ``BatchNorm`` on the last axis of [B, T, C], by default without
    scale and bias (the text aligner's); ``affine=True`` adds flax's
    ``scale`` (here ``weight``) and ``bias`` (the conformer's).

    In train mode the batch's mean and its *biased* variance (flax's
    E[x²] - E[x]², clamped at 0) over every position, padding included,
    normalise ``x``, and the running stats move as
    ``stat = momentum * stat + (1 - momentum) * batch_stat``.  Over R
    ranks the moments are the global batch's (``parallel/mesh.py``).
    ``nn.BatchNorm1d`` would store the unbiased variance and a
    ``num_batches_tracked`` buffer that flax does not have.  In eval mode
    the running stats normalise."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, affine: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.mean, self.var
        else:
            mean, var = mesh.moments(x.float().reshape(-1, x.shape[-1]))
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean.detach() * (1.0 - self.momentum))
                self.var.mul_(self.momentum).add_(
                    var.detach() * (1.0 - self.momentum))
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in
        # f32, cast to x's type at the end
        mul = torch.rsqrt(var + self.eps)
        if self.weight is None:
            return ((x.float() - mean) * mul).to(x.dtype)
        out = (x.float() - mean) * (mul * self.weight.float())
        return (out + self.bias.float()).to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis with learned gamma/beta,
    eps 1e-4."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # normalised in f32 and rounded to x's type, then the affine in that
        # type: the JAX package's cast points under bf16
        x = F.layer_norm(x, x.shape[-1:], eps=1e-4)
        return x * self.gamma + self.beta


class _StyleAffine(nn.Module):
    """style [B, S] -> (gamma, beta) each [B, 1, C] through ``fc``."""

    def __init__(self, channels: int, style_dim: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels)

    def affine(self, style: torch.Tensor):
        return self.fc(style)[:, None, :].chunk(2, dim=-1)


class AdaptiveLayerNorm(_StyleAffine):
    """LayerNorm without affine + style-predicted (1+γ)·x + β."""

    def __init__(self, channels: int, style_dim: int, eps: float = 1e-5):
        super().__init__(channels, style_dim)
        self.eps = eps

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine(style)
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return (1.0 + gamma) * x + beta


class AdaptiveInstanceNorm(_StyleAffine):
    """Instance norm over time (per sample, per channel, eps 1e-5) + style
    affine."""

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.affine(style)
        xf = x.float()  # moments and normalisation in f32
        var, mean = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
        x = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
        return (1.0 + gamma) * x + beta


class Conv1d(nn.Module):
    """1-D convolution on [B, T, C] with torch-style symmetric padding
    ``(k·d − d) // 2`` (flax ``Conv1d`` wrapper; the conv itself is its
    ``Conv_0``), stride 1 and a bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                padding=(kernel_size - 1) * dilation // 2,
                                dilation=dilation, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x.transpose(1, 2)).transpose(1, 2)


class Conv1x1(nn.Module):
    """A kernel-1 flax ``nn.Conv`` on [B, T, C]: weight [out, in, 1]."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = (nn.Parameter(torch.zeros(out_channels))
                     if use_bias else None)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class AdaptiveDecoderBlock(nn.Module):
    """Two-conv residual block with AdaIN conditioning, /√2 output."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.AdaptiveInstanceNorm_0 = AdaptiveInstanceNorm(dim_in, style_dim)
        self.conv1 = Conv1d(dim_in, dim_out, 3)
        self.AdaptiveInstanceNorm_1 = AdaptiveInstanceNorm(dim_out, style_dim)
        self.conv2 = Conv1d(dim_out, dim_out, 3)
        self.conv1x1 = (Conv1x1(dim_in, dim_out, use_bias=False)
                        if dim_in != dim_out else None)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.AdaptiveInstanceNorm_0(x, style), 0.2)
        h = self.conv1(self.dropout(h))
        h = F.leaky_relu(self.AdaptiveInstanceNorm_1(h, style), 0.2)
        h = self.conv2(self.dropout(h))
        if self.conv1x1 is not None:
            x = self.conv1x1(x)
        return (h + x) / math.sqrt(2.0)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin²(a·x) / a."""
    return x + torch.sin(alpha * x) ** 2 / alpha


class AdaptiveGeneratorBlock(nn.Module):
    """HiFiGAN-style residual block of the ringformer head: per dilation
    d, AdaIN -> snake -> conv (dilation d) -> AdaIN -> snake -> conv, added
    to the input."""

    def __init__(self, channels: int, style_dim: int, kernel_size: int = 3,
                 dilation=(1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            setattr(self, f"alpha1_{i}", nn.Parameter(
                torch.ones(1, 1, channels)))
            setattr(self, f"alpha2_{i}", nn.Parameter(
                torch.ones(1, 1, channels)))
            setattr(self, f"adain1_{i}", AdaptiveInstanceNorm(channels,
                                                              style_dim))
            setattr(self, f"conv1_{i}", Conv1d(channels, channels,
                                               kernel_size, dilation=d))
            setattr(self, f"adain2_{i}", AdaptiveInstanceNorm(channels,
                                                              style_dim))
            setattr(self, f"conv2_{i}", Conv1d(channels, channels,
                                               kernel_size))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilation)):
            h = snake(getattr(self, f"adain1_{i}")(x, style),
                      getattr(self, f"alpha1_{i}"))
            h = getattr(self, f"conv1_{i}")(h)
            h = snake(getattr(self, f"adain2_{i}")(h, style),
                      getattr(self, f"alpha2_{i}"))
            x = x + getattr(self, f"conv2_{i}")(h)
        return x


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] -> bool [B, max_length], True where valid."""
    positions = torch.arange(max_length, device=lengths.device)
    return positions[None, :] < lengths[:, None]

"""The multi-resolution discriminator ('mrd'): one stack of weight-normed
2-D convs per spectrogram resolution, over the |STFT| image [B, F, T, 1];
and the multi-period discriminator ('mpd'), one stack per period over the
waveform folded to [B, 1, T/p, p].

The four C=32 layers ``conv_1``..``conv_4`` run through the spec-conv
kernels (``ops/spec_conv.py``) on channels-last [B, F, T, 32] activations;
``conv_0`` (one input channel) and the one-channel ``out`` head are
``F.conv2d``, as the JAX package computes both outside Pallas.  Padding is
the symmetric (kf // 2, kt // 2) of the torch reference, not SAME.  Weight
norm is computed in f32 and the result cast back to the weight's type.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spec_conv import spec_conv2d

LRELU_SLOPE = 0.1
# (kernel (freq, time), stride on time) of conv_0 .. conv_4
SPECS = (((3, 9), 1), ((3, 9), 2), ((3, 9), 2), ((3, 9), 2), ((3, 3), 1))


class WNConv2d(nn.Module):
    """Weight and bias of a weight-normed conv, torch layout
    [out, in, kf, kt]; ``scale`` is flax WeightNorm's per-output scale."""

    def __init__(self, in_channels: int, out_channels: int, kernel):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels, *kernel)
            / (in_channels * kernel[0] * kernel[1]) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))

    def normalized(self) -> torch.Tensor:
        w = self.weight.float()
        norm = torch.sqrt(torch.sum(w * w, dim=(1, 2, 3), keepdim=True)
                          + 1e-12)
        return (w / norm * self.scale.float()[:, None, None, None]) \
            .to(self.weight.dtype)


class SpecDiscriminator(nn.Module):
    """[B, F, T, 1] -> (flattened score [B, F*T'], feature maps)."""

    def __init__(self):
        super().__init__()
        for i, (kernel, _) in enumerate(SPECS):
            setattr(self, f"conv_{i}", WNConv2d(1 if i == 0 else 32, 32,
                                                kernel))
        self.out = WNConv2d(32, 1, (3, 3))

    def forward(self, y: torch.Tensor) -> Tuple[torch.Tensor,
                                                List[torch.Tensor]]:
        fmap = []
        conv = self.conv_0
        y = F.conv2d(y.permute(0, 3, 1, 2), conv.normalized(), conv.bias,
                     padding=(1, 4))
        # channels-last activations: [B, F, T, 32] contiguous
        y = F.leaky_relu(y, LRELU_SLOPE).permute(0, 2, 3, 1).contiguous()
        fmap.append(y)
        for i, ((_, kt), stride) in list(enumerate(SPECS))[1:]:
            conv = getattr(self, f"conv_{i}")
            y = spec_conv2d(y, conv.normalized(), conv.bias, stride,
                            LRELU_SLOPE)
            fmap.append(y)
        y = F.conv2d(y.permute(0, 3, 1, 2), self.out.normalized(),
                     self.out.bias, padding=(1, 1))  # [B, 1, F, T']
        fmap.append(y)
        return y.reshape(y.shape[0], -1), fmap


class MultiResolutionDiscriminator(nn.Module):
    """One SpecDiscriminator per spectrogram resolution."""

    def __init__(self, resolution_count: int = 3):
        super().__init__()
        self.resolution_count = resolution_count
        for i in range(resolution_count):
            setattr(self, f"disc_{i}", SpecDiscriminator())

    def forward(self, target_list: Sequence[torch.Tensor],
                pred_list: Sequence[torch.Tensor]):
        real_scores, gen_scores, real_feats, gen_feats = [], [], [], []
        for i in range(self.resolution_count):
            disc = getattr(self, f"disc_{i}")
            score_r, fmap_r = disc(target_list[i])
            score_g, fmap_g = disc(pred_list[i])
            real_scores.append(score_r)
            gen_scores.append(score_g)
            real_feats.append(fmap_r)
            gen_feats.append(fmap_g)
        return real_scores, gen_scores, real_feats, gen_feats


class PeriodDiscriminator(nn.Module):
    """[B, T] -> (flattened score [B, T'·p], feature maps): reflect-pad T
    to a multiple of the period p, fold to the image [B, 1, T/p, p] and
    run weight-normed (5, 1) convs of stride (3, 1) at 32/128/512/1024
    channels, ``conv_4`` at 1024 (stride 1) and the one-channel ``out``
    head (3, 1).  Feature maps are channels-last [B, H, p, C], the first
    conv's left out.  Plain ``F.conv2d``: the JAX package computes these
    convs in XLA, not in Pallas."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period, self.kernel_size, self.stride = period, kernel_size, \
            stride
        widths = (1, 32, 128, 512, 1024)
        for i in range(4):
            setattr(self, f"conv_{i}", WNConv2d(widths[i], widths[i + 1],
                                                (kernel_size, 1)))
        self.conv_4 = WNConv2d(1024, 1024, (kernel_size, 1))
        self.out = WNConv2d(1024, 1, (3, 1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor,
                                                List[torch.Tensor]]:
        b, t = x.shape
        p = self.period
        pad = (p - t % p) % p
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        y = x.reshape(b, 1, -1, p)
        fmap = []
        half = self.kernel_size // 2
        for i in range(4):
            conv = getattr(self, f"conv_{i}")
            y = F.leaky_relu(F.conv2d(y, conv.normalized(), conv.bias,
                                      stride=(self.stride, 1),
                                      padding=(half, 0)), LRELU_SLOPE)
            if i > 0:  # the reference skips the first conv's feature map
                fmap.append(y.permute(0, 2, 3, 1))
        y = F.leaky_relu(F.conv2d(y, self.conv_4.normalized(),
                                  self.conv_4.bias, padding=(half, 0)),
                         LRELU_SLOPE)
        fmap.append(y.permute(0, 2, 3, 1))
        y = F.conv2d(y, self.out.normalized(), self.out.bias,
                     padding=(1, 0))
        fmap.append(y.permute(0, 2, 3, 1))
        return y.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """One PeriodDiscriminator per period (2, 3, 5, 7, 11), as
    ``period_{p}``."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            setattr(self, f"period_{p}", PeriodDiscriminator(p))

    def forward(self, target: torch.Tensor, pred: torch.Tensor):
        real_scores, gen_scores, real_feats, gen_feats = [], [], [], []
        for p in self.periods:
            disc = getattr(self, f"period_{p}")
            score_r, fmap_r = disc(target)
            score_g, fmap_g = disc(pred)
            real_scores.append(score_r)
            gen_scores.append(score_g)
            real_feats.append(fmap_r)
            gen_feats.append(fmap_g)
        return real_scores, gen_scores, real_feats, gen_feats

"""The multi-resolution discriminator ('mrd'): one stack of weight-normed
2-D convs per spectrogram resolution, over the |STFT| image [B, F, T, 1].

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

"""SimAM-ResNet34 with attentive statistics pooling: the frozen speaker
net of the experimental stages (wespeaker's voxblink2 SimAM-ResNet34 with
its bottleneck removed, so its output is the 10240-d statistics vector at
80 mels and 64 base channels).

* front: a 2-D ResNet34 (3/4/6/3 SimAM basic blocks) over the fbank image
  [B, 1, F, T] (height frequency, width time); SimAM is parameter-free;
* pooling: attention over time of the flattened [C * F/8] axis (a 128-wide
  1x1 bottleneck, softmax over time), weighted mean and std concatenated.

The batch norms are frozen inference-mode norms whose statistics sit in
the flax params (``scale``, ``bias``, ``mean``, ``var``); here ``mean`` and
``var`` are buffers.  Module names follow the flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def simam(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Parameter-free SimAM attention over [B, C, H, W], per channel."""
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)) ** 2
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4.0 * (v + eps)) + 0.5)


class _BN(nn.Module):
    """Frozen batch norm over the channel axis ``dim``: (x - mean) /
    sqrt(var + 1e-5) * scale + bias, from stored statistics."""

    def __init__(self, channels: int, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        inv = torch.rsqrt(self.var + 1e-5).view(shape)
        return ((x - self.mean.view(shape)) * inv * self.weight.view(shape)
                + self.bias.view(shape))


def _conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1, bias=False)


class SimAMBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = _BN(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = _BN(planes)
        self.downsample = stride != 1 or in_planes != planes
        if self.downsample:
            self.downsample_conv = nn.Conv2d(in_planes, planes, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = _BN(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = simam(self.bn2(self.conv2(h)))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + x)


class SimAMResNet34(nn.Module):
    """[B, 1, F, T] -> [B, 8m, F/8, T/8] feature maps."""

    def __init__(self, m_channels: int = 64,
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        m = m_channels
        self.conv1 = _conv3x3(1, m)
        self.bn1 = _BN(m)
        self.names = []
        in_planes = m
        for stage, (blocks, planes, stride) in enumerate(
                zip(layers, (m, 2 * m, 4 * m, 8 * m), (1, 2, 2, 2))):
            for i in range(blocks):
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, SimAMBasicBlock(
                    in_planes, planes, stride if i == 0 else 1))
                self.names.append(name)
                in_planes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class ASP(nn.Module):
    """Attentive statistics pooling over time: [B, T', D] -> [B, 2D]."""

    def __init__(self, dim: int, bottleneck: int = 128):
        super().__init__()
        self.att_in = nn.Conv1d(dim, bottleneck, 1)
        self.att_bn = _BN(bottleneck, dim=-1)
        self.att_out = nn.Conv1d(bottleneck, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = F.relu(self.att_in(x.transpose(1, 2))).transpose(1, 2)
        w = self.att_bn(w)
        w = self.att_out(w.transpose(1, 2)).transpose(1, 2)
        w = torch.softmax(w, dim=1)  # over time
        mu = (x * w).sum(dim=1)
        sg = torch.sqrt(torch.clamp((x * x * w).sum(dim=1) - mu * mu,
                                    min=1e-5))
        return torch.cat([mu, sg], dim=-1)


class SimAMResNet34ASP(nn.Module):
    """fbank [B, T, n_mels] -> the pre-bottleneck embedding
    [B, 2 * 8m * (n_mels / 8)]."""

    def __init__(self, m_channels: int = 64, n_mels: int = 80):
        super().__init__()
        self.front = SimAMResNet34(m_channels)
        self.pooling = ASP(8 * m_channels * (n_mels // 8))

    @staticmethod
    def out_dim(m_channels: int, n_mels: int) -> int:
        return 2 * 8 * m_channels * (n_mels // 8)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.front(feats.transpose(1, 2)[:, None])  # [B, C, F', T']
        b, c, f, t = x.shape
        # the statistics axis flattens (C, F), C-major
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * f)
        return self.pooling(x)

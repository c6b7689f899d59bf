"""ConvNeXt blocks with Global Response Normalisation on [B, T, C]."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norms import AdaptiveLayerNorm, Conv1d


class GRN(nn.Module):
    """Global Response Normalisation: L2 over time, divisive norm over
    channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()  # the L2 over time accumulates in f32
        gx = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma * (x * nx) + self.beta + x


class BasicConvNeXtBlock(nn.Module):
    """depthwise conv -> LayerNorm -> pointwise MLP (exact GELU, GRN),
    residual."""

    def __init__(self, dim: int, intermediate_dim: int, kernel: int = 7):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel, groups=dim)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.GRN_0 = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(self.dwconv(x))
        h = F.gelu(self.pwconv1(h), approximate="none")
        return x + self.pwconv2(self.GRN_0(h))


class StyleConvNeXtBlock(nn.Module):
    """Style-conditioned variant (AdaLN + SiLU) of the freegan generator."""

    def __init__(self, dim: int, intermediate_dim: int, style_dim: int,
                 kernel: int = 7):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel, groups=dim)
        self.AdaptiveLayerNorm_0 = AdaptiveLayerNorm(dim, style_dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.GRN_0 = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        h = self.AdaptiveLayerNorm_0(self.dwconv(x), style)
        h = F.silu(self.pwconv1(h))
        return x + self.pwconv2(self.GRN_0(h))

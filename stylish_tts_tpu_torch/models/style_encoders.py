"""Text-side style encoder: ConvNeXt stack and masked mean-pool.

The mel-side encoder serves training only and is not ported yet.
"""

from __future__ import annotations

import torch
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

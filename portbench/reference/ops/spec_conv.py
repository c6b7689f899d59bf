"""The MRD's C=32 convolution as plain torch: leaky_relu(conv(x, w) + b)
on channels-last x [B, H, W, 32], torch-layout w [32, 32, 3, kt], zero
padding (1, kt // 2), stride (1, s).  Autograd differentiates it; it
computes in the type of its inputs (f32 in the reference)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

KF = 3


def spec_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int = 1, leaky: float = 0.1) -> torch.Tensor:
    kt = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 stride=(1, stride), padding=(KF // 2, kt // 2))
    return F.leaky_relu(y, leaky).permute(0, 2, 3, 1)

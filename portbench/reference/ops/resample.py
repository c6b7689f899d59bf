"""Polyphase windowed-sinc resampling (``torchaudio.transforms.Resample``'s
kernel): one strided convolution whose ``up`` output channels are the
polyphase branches.  The SLM loss uses it for 24 -> 16 kHz."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                rolloff: float = 0.99):
    """(kernels [up, 1, K], width, up, down): phase i of the output is the
    input convolved with kernels[i] at stride ``down``."""
    gcd = math.gcd(orig_freq, new_freq)
    up = new_freq // gcd
    down = orig_freq // gcd
    base_freq = min(up, down) * rolloff
    width = int(np.ceil(lowpass_filter_width * down / base_freq))
    idx = np.arange(-width, width + down, dtype=np.float64)
    kernels = []
    for i in range(up):
        t = (-i / up + idx / down) * base_freq
        t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
        window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
        scale = base_freq / down
        denom = np.where(t == 0, 1.0, np.pi * t)
        kernel = np.where(t == 0, 1.0, np.sin(np.pi * t) / denom)
        kernels.append(kernel * window * scale)
    k = np.stack(kernels)[:, None, :].astype(np.float32)
    k.flags.writeable = False
    return k, width, up, down


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """[B, T] -> [B, ceil(T * new / orig)]."""
    if orig_freq == new_freq:
        return x
    kernels, width, up, down = sinc_kernel(orig_freq, new_freq)
    t = x.shape[-1]
    weight = torch.from_numpy(np.array(kernels)).to(x.device, x.dtype)
    padded = F.pad(x[:, None, :], (width, width + down))
    out = F.conv1d(padded, weight, stride=down)  # [B, up, frames]
    interleaved = out.transpose(1, 2).reshape(x.shape[0], -1)
    return interleaved[:, : int(math.ceil(t * new_freq / orig_freq))]

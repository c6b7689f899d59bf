"""Wrapper of the Hopper forward-STFT kernel (``csrc/stft.cu``).

It replaces the TPU kernel ``stylish_tts_tpu/ops/stft_pallas.py:stft_pallas``
and serves every STFT of the port: the generator's harmonic prior, the
loss spectrograms, the magphase target and the posterior encoder.  A tensor
on the CPU goes to the plain version (``ops/stft.py:stft``); a CUDA tensor
goes to the kernel, or the wrapper raises.

The gradient is the transpose of the windowed-DFT product, then
overlap-add, then the adjoint of the reflect pad, in torch ops: the JAX
package's gradient is XLA's autodiff of the same product (its Pallas
kernel has no VJP), so there is no backward kernel to port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import stft as plain
from .build import load_library

_KC = 16       # taps per pipeline step of the kernel (padding of the rows)
_TILE_C = 128  # basis columns per block (padding of the columns)
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_taps(n_fft: int, win_length: int) -> Tuple[int, int]:
    """[lo, hi): the taps where the padded window is non-zero; the basis is
    zero elsewhere, so the kernel multiplies only these."""
    nonzero = np.flatnonzero(plain._padded_window(win_length, n_fft).numpy())
    return int(nonzero[0]), int(nonzero[-1]) + 1


@functools.lru_cache(maxsize=16)
def _kernel_basis(n_fft: int, win_length: int, device: torch.device):
    """Basis rows [lo, hi) padded to a multiple of 16 rows and 128 columns."""
    lo, hi = window_taps(n_fft, win_length)
    rows = plain.forward_basis(n_fft, win_length)[lo:hi]
    k_pad = _round_up(hi - lo, _KC)
    c_pad = _round_up(rows.shape[1], _TILE_C)
    padded = np.zeros((k_pad, c_pad), np.float32)
    padded[: hi - lo, : rows.shape[1]] = rows
    return torch.from_numpy(padded).to(device), lo, k_pad, c_pad


class StftKernel:
    """Callable wrapper; ``launches`` counts the kernel's launches."""

    name = "stft_forward"
    route = "cuda"
    source = "stylish_tts_tpu_torch/csrc/stft.cu"
    replaces = "stylish_tts_tpu/ops/stft_pallas.py:81"

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            lib = load_library("stft")
            lib.stft_forward_f32.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            )
            lib.stft_forward_f32.restype = ctypes.c_int
            lib.stft_forward_smem_bytes.argtypes = [ctypes.c_int] * 2
            lib.stft_forward_smem_bytes.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, *, n_fft: int, hop_length: int,
                 win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Centered, reflect-padded real STFT of [B, T] ->
        (real, imag), each [B, frames, n_fft//2+1], differentiable in x."""
        return _Stft.apply(x, n_fft, hop_length, win_length, self)

    def launch(self, x: torch.Tensor, n_fft: int, hop_length: int,
               win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.device.type == "cpu":
            return plain.stft(x, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length)
        if x.device.type != "cuda":
            raise ValueError(f"stft kernel: unsupported device {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"stft kernel takes float32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"stft kernel takes [B, T], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("stft kernel needs a contiguous input")
        batch, t = x.shape
        pad = n_fft // 2
        if t <= pad:
            raise ValueError(f"reflect padding needs T > {pad}, got T={t}")
        freq_bins = n_fft // 2 + 1
        frames = 1 + (t + 2 * pad - n_fft) // hop_length
        basis, lo, k_pad, c_pad = _kernel_basis(n_fft, win_length, x.device)
        lib = self._library()
        smem = lib.stft_forward_smem_bytes(hop_length, k_pad)
        if smem > _MAX_SMEM:
            raise ValueError(f"hop {hop_length} needs {smem} B of shared memory")
        real = torch.empty((batch, frames, freq_bins), dtype=torch.float32,
                           device=x.device)
        imag = torch.empty_like(real)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.stft_forward_f32(
                x.data_ptr(), basis.data_ptr(), real.data_ptr(),
                imag.data_ptr(), batch, t, frames, pad, hop_length, lo,
                k_pad, freq_bins, c_pad, stream,
            )
        if err != 0:
            raise RuntimeError(f"stft kernel launch failed: CUDA error {err}")
        self.launches += 1
        return real, imag


def reflect_pad_adjoint(g: torch.Tensor, pad: int) -> torch.Tensor:
    """Adjoint of reflect-padding [B, T] by ``pad`` on both sides:
    [B, T + 2 pad] -> [B, T]."""
    t = g.shape[1] - 2 * pad
    dx = g[:, pad:pad + t].clone()
    dx[:, 1:pad + 1] += g[:, :pad].flip(-1)
    dx[:, t - 1 - pad:t - 1] += g[:, pad + t:].flip(-1)
    return dx


class _Stft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_fft, hop_length, win_length, kernel):
        ctx.meta = (x.shape[1], n_fft, hop_length, win_length)
        return kernel.launch(x, n_fft, hop_length, win_length)

    @staticmethod
    def backward(ctx, d_real, d_imag):
        t, n_fft, hop, win = ctx.meta
        grads = [d for d in (d_real, d_imag) if d is not None]
        zeros = torch.zeros_like(grads[0])
        coeffs = torch.cat([zeros if d_real is None else d_real,
                            zeros if d_imag is None else d_imag], dim=-1)
        basis = plain._on_device("forward", n_fft, win, coeffs.device)
        frames = torch.matmul(coeffs, basis.T)  # [B, frames, n_fft]
        padded = plain._overlap_add(frames, hop)
        pad = n_fft // 2
        padded = torch.nn.functional.pad(
            padded, (0, t + 2 * pad - padded.shape[1]))
        return reflect_pad_adjoint(padded, pad), None, None, None, None


stft_forward = StftKernel()

"""Wrapper of the Hopper forward-STFT kernel (``csrc/stft.cu``).

It replaces the TPU kernel ``stylish_tts_tpu/ops/stft_pallas.py:stft_pallas``
and serves every STFT of the port: the generator's harmonic prior (the
freegan head's and the ringformer's source), the loss spectrograms, the
magphase target and the posterior encoder.  A tensor on the CPU goes to
the plain version (``ops/stft.py:stft``); a CUDA tensor goes to one of the
kernel's two paths, or the wrapper raises:

* the FFT path (``stft_fft_kernel``, a shared-memory real FFT) for n_fft a
  power of two from 256 to 4096 (``N_FFT_SIZES``);
* the DFT path (``stft_dft_kernel``, the windowed DFT by f32 FMAs over the
  window's taps) for even n_fft up to 128 (``DFT_MAX_N_FFT``): the
  ringformer head's 60-point STFT.

The FFT path reads two host-made tables: the port's f32 padded window and
the FFT's twiddles (``StftKernel.twiddles``, which ``csrc/stft.cu`` makes
and lays out); the DFT path reads the plain version's windowed basis
(``ops/stft.py:forward_basis``).  Each is uploaded once per device.

The gradient is the transpose of the windowed-DFT product, then
overlap-add, then the adjoint of the reflect pad, in torch ops: the JAX
package's gradient is XLA's autodiff of the same product (its Pallas
kernel has no VJP), so there is no backward kernel to port.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import stft as plain
from .build import load_library

N_FFT_SIZES = (256, 512, 1024, 2048, 4096)  # the FFT path's sizes
DFT_MAX_N_FFT = 128  # the DFT path takes even n_fft up to this
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def window_taps(n_fft: int, win_length: int) -> Tuple[int, int]:
    """[lo, hi): the taps where the padded window is non-zero; the kernel
    stages and loads only these."""
    nonzero = np.flatnonzero(plain._padded_window(win_length, n_fft).numpy())
    return int(nonzero[0]), int(nonzero[-1]) + 1


def kernel_path(n_fft: int) -> str:
    """"fft" or "dft": the path of the kernel that takes ``n_fft``;
    raises for an n_fft neither takes."""
    if n_fft in N_FFT_SIZES:
        return "fft"
    if 2 <= n_fft <= DFT_MAX_N_FFT and n_fft % 2 == 0:
        return "dft"
    raise ValueError(f"stft kernel takes n_fft in {N_FFT_SIZES} (FFT path) "
                     f"or even n_fft <= {DFT_MAX_N_FFT} (DFT path), got "
                     f"{n_fft}")


class StftKernel:
    """Callable wrapper; ``launches`` counts the kernel's launches (both
    paths), ``launches_by_n_fft`` the launches at each n_fft."""

    name = "stft_forward"
    route = "cuda"
    source = "stylish_tts_tpu_torch/csrc/stft.cu"
    replaces = "stylish_tts_tpu/ops/stft_pallas.py:81"

    def __init__(self):
        self.launches = 0
        self.launches_by_n_fft = {}
        self._lib = None
        self._tables = {}

    def _library(self):
        if self._lib is None:
            lib = load_library("stft")
            lib.stft_fft_f32.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            )
            lib.stft_fft_f32.restype = ctypes.c_int
            lib.stft_fft_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.stft_fft_smem_bytes.restype = ctypes.c_int
            lib.stft_fft_twiddles.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p]
            lib.stft_fft_twiddles.restype = ctypes.c_int
            lib.stft_dft_f32.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            )
            lib.stft_dft_f32.restype = ctypes.c_int
            lib.stft_dft_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.stft_dft_smem_bytes.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def twiddles(self, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
        """The kernel's twiddle table, made by the library: (exponents p,
        int32 [entries]; values, f32 [entries, 2] (real, imag) of
        e^{-2πi p/n_fft}, made in float64 and rounded once)."""
        lib = self._library()
        count = lib.stft_fft_twiddles(n_fft, None, None)
        if count < 0:
            raise ValueError(f"stft kernel takes n_fft in {N_FFT_SIZES}, "
                             f"got {n_fft}")
        exponent = np.empty(count, np.int32)
        table = np.empty((count, 2), np.float32)
        lib.stft_fft_twiddles(n_fft, exponent.ctypes.data, table.ctypes.data)
        return exponent, table

    def tables(self, n_fft: int, win_length: int, device: torch.device):
        """The FFT path's window and twiddles, or the DFT path's windowed
        basis [n_fft, 2 (n_fft/2 + 1)], on ``device``, uploaded once, and
        the taps."""
        key = (n_fft, win_length, device)
        if key not in self._tables:
            taps = window_taps(n_fft, win_length)
            if kernel_path(n_fft) == "dft":
                basis = torch.from_numpy(np.array(plain.forward_basis(
                    n_fft, win_length))).to(device)
                self._tables[key] = (basis, *taps)
            else:
                window = plain._padded_window(win_length, n_fft).to(device)
                tw = torch.from_numpy(self.twiddles(n_fft)[1]).to(device)
                self._tables[key] = (window, tw, *taps)
        return self._tables[key]

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
        path = kernel_path(n_fft)
        batch, t = x.shape
        pad = n_fft // 2
        if t <= pad:
            raise ValueError(f"reflect padding needs T > {pad}, got T={t}")
        if t + 2 * pad + hop_length >= 2**31:
            raise ValueError(f"stft kernel indexes in 32 bits, got T={t}")
        freq_bins = n_fft // 2 + 1
        frames = 1 + (t + 2 * pad - n_fft) // hop_length
        tables = self.tables(n_fft, win_length, x.device)
        lo, hi = tables[-2:]
        lib = self._library()
        smem_bytes = (lib.stft_dft_smem_bytes if path == "dft"
                      else lib.stft_fft_smem_bytes)
        smem = smem_bytes(n_fft, hop_length, hi - lo)
        if smem > _MAX_SMEM:
            raise ValueError(f"hop {hop_length} needs {smem} B of shared memory")
        real = torch.empty((batch, frames, freq_bins), dtype=torch.float32,
                           device=x.device)
        imag = torch.empty_like(real)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if path == "dft":
                err = lib.stft_dft_f32(
                    x.data_ptr(), tables[0].data_ptr(), real.data_ptr(),
                    imag.data_ptr(), batch, t, frames, pad, hop_length,
                    n_fft, lo, hi, stream,
                )
            else:
                err = lib.stft_fft_f32(
                    x.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
                    real.data_ptr(), imag.data_ptr(), batch, t, frames, pad,
                    hop_length, n_fft, lo, hi, stream,
                )
        if err != 0:
            raise RuntimeError(f"stft kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.launches_by_n_fft[n_fft] = \
            self.launches_by_n_fft.get(n_fft, 0) + 1
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

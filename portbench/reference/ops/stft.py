"""STFT / iSTFT as framed matmuls against windowed DFT bases.

The same formulation as the JAX package (not ``torch.stft``/``torch.istft``),
so the two agree to f32 rounding: a frame of audio times a precomputed
``[n_fft, 2*freq_bins]`` windowed DFT basis gives (real, imag), and the
inverse is a basis matmul plus overlap-add with window-envelope
normalisation.  Conventions follow ``torch.stft(center=True,
pad_mode="reflect", onesided=True)`` and ``torch.istft``.

Layout: waveforms are ``[B, T]``; spectrograms ``[B, frames, freq]``.

``stft`` here is the plain version of the Hopper kernel in
``csrc/stft.cu``; callers reach the kernel through ``ops/stft_kernel.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True)), computed in
    f32 the way the JAX package builds it on device, so the bases agree bit
    for bit where it matters (the sin(π) terms of the Nyquist column)."""
    n = torch.arange(win_length, dtype=torch.float32)
    return 0.5 - 0.5 * torch.cos(n * np.float32(2.0 * np.pi / win_length))


def _padded_window(win_length: int, n_fft: int) -> torch.Tensor:
    """Hann window center-padded to n_fft (torch.stft convention)."""
    w = hann_window(win_length)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = F.pad(w, (left, n_fft - win_length - left))
    elif win_length > n_fft:
        w = w[:n_fft]
    return w


def _dft_angles(n_fft: int, freq_bins: int) -> torch.Tensor:
    """[n_fft, freq_bins] f32 angles 2π·((n·k) mod N)/N; the phase is
    reduced in exact integers before the f32 multiply."""
    n = torch.arange(n_fft, dtype=torch.int64)[:, None]
    k = torch.arange(freq_bins, dtype=torch.int64)[None, :]
    return ((n * k) % n_fft).to(torch.float32) \
        * np.float32(2.0 * np.pi / n_fft)


@functools.lru_cache(maxsize=32)
def forward_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed forward DFT basis, shape [n_fft, 2 * freq_bins].

    Columns 0..F-1 give the real part, F..2F-1 the imaginary part
    (torch's e^{-j2πkn/N} sign convention)."""
    angle = _dft_angles(n_fft, n_fft // 2 + 1)
    window = _padded_window(win_length, n_fft)[:, None]
    basis = torch.cat(
        [torch.cos(angle) * window, -torch.sin(angle) * window], dim=1
    ).numpy()
    basis.flags.writeable = False
    return basis


@functools.lru_cache(maxsize=32)
def inverse_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed inverse DFT basis, shape [2 * freq_bins, n_fft]: maps the
    (real, imag) rFFT coefficients of one frame to w[n] * irfft(X)[n],
    doubling the non-DC/non-Nyquist bins of the onesided transform."""
    freq_bins = n_fft // 2 + 1
    angle = _dft_angles(n_fft, freq_bins).T  # [F, n_fft]
    k = torch.arange(freq_bins)[:, None]
    nyquist = (n_fft % 2 == 0) & (k == freq_bins - 1)
    scale = torch.where((k == 0) | nyquist, 1.0, 2.0) / n_fft
    window = _padded_window(win_length, n_fft)[None, :]
    basis = torch.cat(
        [torch.cos(angle) * scale * window,
         -torch.sin(angle) * scale * window], dim=0
    ).numpy()
    basis.flags.writeable = False
    return basis


@functools.lru_cache(maxsize=32)
@functools.lru_cache(maxsize=32)
def _on_device(kind: str, n_fft: int, win_length: int,
               device: torch.device) -> torch.Tensor:
    """The basis on ``device``, uploaded once: a copy from the host at
    every call would wait for the work already queued on the card."""
    table = {"forward": forward_basis, "inverse": inverse_basis,
             "window_sq": _window_sq}[kind]
    return torch.from_numpy(np.array(table(n_fft, win_length))).to(device)


def _window_sq(n_fft: int, win_length: int) -> np.ndarray:
    """The padded window squared: the iSTFT's overlap-add envelope."""
    return (_padded_window(win_length, n_fft) ** 2).numpy()


def stft(
    x: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int,
    center: bool = True,
    pad_mode: str = "reflect",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real STFT of [B, T] -> (real, imag), each [B, frames, n_fft//2+1]."""
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode=pad_mode)[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # [B, frames, n_fft] view
    basis = _on_device("forward", n_fft, win_length, x.device)
    out = torch.matmul(frames, basis)  # [B, frames, 2F]
    freq_bins = n_fft // 2 + 1
    return out[..., :freq_bins], out[..., freq_bins:]


def _overlap_add(frames_time: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, frames, n_fft] -> [B, (frames-1)*hop + n_fft] overlap-add, as
    K = ceil(n_fft/hop) shifted adds of [B, frames, hop] chunks: chunk k of
    frame t lands at output row t+k."""
    b, n_frames, n_fft = frames_time.shape
    k_chunks = -(-n_fft // hop_length)
    padded = F.pad(frames_time, (0, k_chunks * hop_length - n_fft))
    chunks = padded.reshape(b, n_frames, k_chunks, hop_length)
    out_frames = n_frames + k_chunks - 1
    y = frames_time.new_zeros((b, out_frames, hop_length))
    for k in range(k_chunks):
        y[:, k : k + n_frames] += chunks[:, :, k]
    return y.reshape(b, out_frames * hop_length)[
        :, : (n_frames - 1) * hop_length + n_fft
    ]


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int,
    length: Optional[int] = None,
    center: bool = True,
    eps: float = 1e-11,
) -> torch.Tensor:
    """Inverse STFT of [B, frames, F] (real, imag) -> [B, T]:
    y = OLA(w · irfft(X)) / OLA(w²), then the center padding is trimmed."""
    basis = _on_device("inverse", n_fft, win_length, real.device)
    # f32 whatever the coefficients' type, as the JAX package's promoting
    # f32 einsum
    coeffs = torch.cat([real, imag], dim=-1).float()  # [B, frames, 2F]
    y = _overlap_add(torch.matmul(coeffs, basis), hop_length)

    n_frames = real.shape[1]
    w2 = _on_device("window_sq", n_fft, win_length, y.device)
    env = _overlap_add(w2.expand(1, n_frames, n_fft), hop_length)
    y = y / torch.clamp(env, min=eps)

    pad = n_fft // 2 if center else 0
    if length is not None:
        # torch.istft: trim `pad` from the head only, take `length` samples
        end = pad + length
        if y.shape[1] < end:
            y = F.pad(y, (0, end - y.shape[1]))
        y = y[:, pad:end]
    elif center:
        y = y[:, pad:-pad]
    return y


class STFTHead:
    """Bound STFT config: transform() returns (|S|, cos, sin) and inverse()
    reconstructs audio from magnitude and unit phase."""

    def __init__(self, filter_length: int, hop_length: int, win_length: int):
        self.n_fft = filter_length
        self.hop_length = hop_length
        self.win_length = win_length

    def transform(self, x: torch.Tensor):
        # imported here: stft_kernel imports this module for the plain version
        from .stft_kernel import stft_forward

        real, imag = stft_forward(
            x, n_fft=self.n_fft, hop_length=self.hop_length,
            win_length=self.win_length,
        )
        mag = torch.hypot(real, imag) + 1e-9
        return mag, real / mag, imag / mag

    def inverse(self, magnitude, cos, sin, length=None):
        return istft(
            magnitude * cos,
            magnitude * sin,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            win_length=self.win_length,
            length=length,
        )

"""The STFT's oracle for the port's tests: numpy's float64 rfft of the
windowed frames.  Imports no JAX, so the card-only tests can use it on a
machine without JAX, and the CPU tests can use it without loading the
card-only test module."""

from __future__ import annotations

import numpy as np

from stylish_tts_tpu_torch.ops import stft as plain


def rfft_frames(x: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """numpy.fft.rfft, in float64, of the reflect-padded frames of x [B, T]
    times the port's f32 padded window: [B, frames, n_fft//2+1] complex."""
    pad = n_fft // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    frames = 1 + (xp.shape[1] - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = plain._padded_window(win, n_fft).numpy().astype(np.float64)
    return np.fft.rfft(xp[:, idx] * window, axis=-1)

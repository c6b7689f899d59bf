"""The STFT's work (from ``chip_smoke.py:stft_numbers``): a real FFT of
n_fft points a frame, 2.5 n_fft log2 n_fft FLOP (half a complex radix-2
FFT's 5 N log2 N), plus the window's n_fft products, whichever path (FFT
or DFT) computes it; bytes are the f32 signal and window read once and
(real, imag) written once.  Centred frames: T // hop + 1."""

from __future__ import annotations

import math


def frames(samples: int, hop: int) -> int:
    return samples // hop + 1


def work(batch: int, samples: int, n_fft: int, hop: int) -> tuple:
    """(FLOP, bytes) of one STFT of [batch, samples]."""
    n_frames, freq = frames(samples, hop), n_fft // 2 + 1
    flops = batch * n_frames * (2.5 * n_fft * math.log2(n_fft) + n_fft)
    nbytes = 4.0 * (batch * samples + n_fft + 2 * batch * n_frames * freq)
    return flops, nbytes


def istft_flops(batch: int, n_frames: int, n_fft: int) -> float:
    """An inverse real FFT a frame and the window's products: the forward's
    count on the same frames."""
    return batch * n_frames * (2.5 * n_fft * math.log2(n_fft) + n_fft)

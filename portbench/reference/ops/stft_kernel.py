"""The STFT the models call, as the plain version: the reference runs no
kernel of the program."""

from __future__ import annotations

from . import stft as plain


def stft_forward(x, *, n_fft: int, hop_length: int, win_length: int):
    return plain.stft(x, n_fft=n_fft, hop_length=hop_length,
                      win_length=win_length)

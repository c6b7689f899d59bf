"""The port's STFT, iSTFT and STFTHead against the JAX package, and the
STFT kernel's wrapper (its plain path here, the kernel on a card)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.ops import stft as jstft
from stylish_tts_tpu_torch.ops import stft as pstft
from stylish_tts_tpu_torch.ops.stft_kernel import (kernel_path,
                                                   stft_forward, window_taps)
from test_torch_port_helpers import assert_close
from torch_port_stft_oracle import rfft_frames

# (n_fft, hop, win): the generator's prior STFT, then the loss
# resolutions, then the ringformer head's source and magphase grid (the
# kernel's DFT path)
SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
          (2048, 240, 1200), (2048, 300, 1200), (60, 15, 60)]


def _audio(n_fft, hop, batch=2, seed=0):
    # a length that is no multiple of the hop, so the last frame is partial
    t = 4 * n_fft + 13 * hop + 7
    return np.random.default_rng(seed).standard_normal((batch, t)) \
        .astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_stft_matches_jax_and_pallas_interpret(n_fft, hop, win, monkeypatch):
    from jax.experimental import pallas as pl

    import stylish_tts_tpu.ops.stft_pallas as sp

    x = _audio(n_fft, hop)
    real, imag = pstft.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop,
                            win_length=win)
    r0, i0 = jax.jit(functools.partial(
        jstft.stft, n_fft=n_fft, hop_length=hop, win_length=win))(
            jnp.asarray(x))
    # f32 sums of up to n_fft products in another order
    assert_close(real, r0, what="real vs jax stft")
    assert_close(imag, i0, what="imag vs jax stft")

    # the TPU kernel itself, run in Pallas interpret mode
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    r1, i1 = sp.stft_pallas.__wrapped__(
        jnp.asarray(x), n_fft=n_fft, hop_length=hop, win_length=win)
    assert_close(real, r1, what="real vs stft_pallas")
    assert_close(imag, i1, what="imag vs stft_pallas")


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_istft_and_head_match_jax(n_fft, hop, win):
    rng = np.random.default_rng(1)
    frames, freq = 40, n_fft // 2 + 1
    real = rng.standard_normal((2, frames, freq)).astype(np.float32)
    imag = rng.standard_normal((2, frames, freq)).astype(np.float32)
    for length in (None, 30 * hop + 5):
        y = pstft.istft(torch.from_numpy(real), torch.from_numpy(imag),
                        n_fft=n_fft, hop_length=hop, win_length=win,
                        length=length)
        y0 = jax.jit(functools.partial(
            jstft.istft, n_fft=n_fft, hop_length=hop, win_length=win,
            length=length))(jnp.asarray(real), jnp.asarray(imag))
        # a matmul over 2F coefficients, then the envelope division
        assert_close(y, y0, what=f"istft length={length}")

    head, head0 = pstft.STFTHead(n_fft, hop, win), jstft.STFTHead(n_fft, hop,
                                                                   win)
    x = _audio(n_fft, hop, seed=2)
    mag, cos, sin = head.transform(torch.from_numpy(x))
    mag0, cos0, sin0 = jax.jit(head0.transform)(jnp.asarray(x))
    assert_close(mag, mag0, what="head magnitude")
    # unit phase: |cos|,|sin| <= 1; a bin's error is its stft error over
    # its magnitude, so compare where the magnitude is not tiny
    keep = np.asarray(mag0) > 1e-2 * float(np.max(np.asarray(mag0)))
    assert_close(cos.numpy()[keep], np.asarray(cos0)[keep], rel=1e-3,
                 what="head cos")
    assert_close(sin.numpy()[keep], np.asarray(sin0)[keep], rel=1e-3,
                 what="head sin")
    y = head.inverse(mag, cos, sin, length=x.shape[1])
    y0 = jax.jit(functools.partial(head0.inverse, length=x.shape[1]))(
        mag0, cos0, sin0)
    assert_close(y, y0, what="head inverse")
    # an STFT round trip returns the signal
    assert_close(y, x, rel=1e-4, what="round trip")


def test_wrapper_takes_the_plain_path_on_cpu():
    n_fft, hop, win = SHAPES[0]
    x = torch.from_numpy(_audio(n_fft, hop))
    before = stft_forward.launches
    real, imag = stft_forward(x, n_fft=n_fft, hop_length=hop, win_length=win)
    r0, i0 = pstft.stft(x, n_fft=n_fft, hop_length=hop, win_length=win)
    assert torch.equal(real, r0) and torch.equal(imag, i0)
    assert stft_forward.launches == before  # no kernel ran
    # an input that requires a gradient gets the wrapper's own backward
    # (the transposed DFT product, overlap-add, reflect-pad adjoint): it
    # equals autograd of the plain version, with no kernel launched
    xg, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    real, imag = stft_forward(xg, n_fft=n_fft, hop_length=hop,
                              win_length=win)
    (real.sum() + 2 * imag.sum()).backward()
    r0, i0 = pstft.stft(xp, n_fft=n_fft, hop_length=hop, win_length=win)
    (r0.sum() + 2 * i0.sum()).backward()
    torch.testing.assert_close(xg.grad, xp.grad, rtol=1e-5, atol=1e-4)
    assert stft_forward.launches == before
    # neither the CPU nor a card: no plain path, no kernel
    with pytest.raises(ValueError, match="unsupported device"):
        stft_forward(x.detach().to("meta"), n_fft=n_fft, hop_length=hop,
                     win_length=win)
    # the kernel multiplies only the taps where the window is non-zero
    lo, hi = window_taps(n_fft, win)
    basis = pstft.forward_basis(n_fft, win)
    assert not basis[:lo].any() and not basis[hi:].any()
    assert basis[lo].any() and basis[hi - 1].any()


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_stft_is_the_rfft_of_the_windowed_frames(n_fft, hop, win):
    # the function the kernel computes by an FFT: sign, bin count and
    # frame positions against numpy's float64 rfft of the reflect-padded,
    # windowed frames
    x = _audio(n_fft, hop)
    real, imag = pstft.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop,
                            win_length=win)
    ref = rfft_frames(x, n_fft, hop, win)
    assert real.shape == imag.shape == ref.shape
    # f32 sums of up to win products against float64
    scale = np.abs(ref).max()
    assert np.abs(real.numpy() - ref.real).max() <= 1e-5 * scale
    assert np.abs(imag.numpy() - ref.imag).max() <= 1e-5 * scale



def test_kernel_paths_and_the_small_n_fft_gradient():
    """n_fft picks the kernel's path (no fallback: a size neither path
    takes raises), and the wrapper's own backward at the ringformer's
    60/15/60 equals the JAX STFT's VJP."""
    assert [kernel_path(n) for n in (60, 2, 128, 256, 4096)] == \
        ["dft", "dft", "dft", "fft", "fft"]
    for bad in (61, 130, 200, 8192):
        with pytest.raises(ValueError, match="DFT path"):
            kernel_path(bad)
    n_fft, hop, win = 60, 15, 60
    x = _audio(n_fft, hop, seed=3)
    rng = np.random.default_rng(4)
    frames = 1 + x.shape[1] // hop
    g = [rng.standard_normal((2, frames, 31)).astype(np.float32)
         for _ in range(2)]
    fn = functools.partial(jstft.stft, n_fft=n_fft, hop_length=hop,
                           win_length=win)
    (want,) = jax.jit(lambda x, g: jax.vjp(fn, x)[1](g))(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in g))
    xt = torch.from_numpy(x).requires_grad_()
    before = stft_forward.launches
    real, imag = stft_forward(xt, n_fft=n_fft, hop_length=hop,
                              win_length=win)
    ((real * torch.from_numpy(g[0])).sum()
     + (imag * torch.from_numpy(g[1])).sum()).backward()
    assert stft_forward.launches == before  # the plain path on the CPU
    assert_close(xt.grad, want, rel=1e-5, what="d stft / dx at n_fft 60")

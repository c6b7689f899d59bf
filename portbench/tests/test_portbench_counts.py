"""The work counts against hand arithmetic at one shape of each
operation."""

import math

import pytest
import torch

from portbench.counts import flops, peaks, spec_conv, stft


def test_stft_work_by_hand():
    # [2, 24000] at n_fft 1024, hop 256: 24000 // 256 + 1 = 94 frames of
    # 513 bins; 2.5 * 1024 * 10 + 1024 = 26624 FLOP a frame
    f, b = stft.work(2, 24000, 1024, 256)
    assert f == 2 * 94 * 26624
    assert b == 4.0 * (2 * 24000 + 1024 + 2 * 2 * 94 * 513)
    assert stft.istft_flops(2, 94, 1024) == f


def test_spec_conv_work_by_hand():
    # x [2, 257, 101, 32], kt 9, stride 2: W_out 51
    f, b = spec_conv.work("forward", 2, 257, 101, 9, 2)
    assert f == 2.0 * 2 * 257 * 51 * 3 * 9 * 32 * 32
    x, d, w = 2 * 257 * 101 * 32, 2 * 257 * 51 * 32, 3 * 9 * 32 * 32
    assert b == 2 * (x + w + 32 + d)
    assert spec_conv.work("dgrad", 2, 257, 101, 9, 2) == (f, 2 * (d + w + x))
    assert spec_conv.work("wgrad", 2, 257, 101, 9, 2) == (
        f, 2 * (x + d) + 4 * w)


def test_bound_takes_the_longer_of_bytes_and_flop():
    assert peaks.bound_s(67e12, 1.0, "f32") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 0.0, "bf16") == pytest.approx(1.0)


def test_dtype_flops_counts_by_type():
    a32, b32 = torch.randn(8, 16), torch.randn(16, 4)
    x = torch.randn(2, 3, 10)
    w = torch.randn(5, 3, 3)
    with flops.DtypeFlops() as counter:
        a32 @ b32
        a32.bfloat16() @ b32.bfloat16()
        torch.nn.functional.conv1d(x, w)
    assert counter.flops["bf16"] == 2 * 8 * 16 * 4
    # 2 * 8 * 16 * 4 for the f32 product; the conv: 2 * batch * out
    # channels * out length * in channels * taps
    assert counter.flops["f32"] == 2 * 8 * 16 * 4 + 2 * 2 * 5 * 8 * 3 * 3


def test_stft_counted_by_the_fft_formula_with_its_gradient():
    from portbench.reference.ops import stft_kernel

    counter = flops.DtypeFlops()
    x = torch.randn(2, 4800, requires_grad=True)
    with flops.ExitStack() as stack:
        for patch in flops._patches(counter):
            stack.enter_context(patch)
        with counter:
            real, imag = stft_kernel.stft_forward(x, n_fft=256,
                                                  hop_length=64,
                                                  win_length=256)
            (real.sum() + imag.sum()).backward()
    per = 2 * (4800 // 64 + 1) * (2.5 * 256 * math.log2(256) + 256)
    assert real.shape == (2, 76, 129)
    assert counter.flops["f32"] == 2 * per
    assert x.grad is not None and "bf16" not in counter.flops

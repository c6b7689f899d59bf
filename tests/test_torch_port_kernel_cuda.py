"""The Hopper kernels (STFT; the MRD's spec-conv forward, dgrad and
wgrad) against their plain versions, on the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_kernel_cuda.py

Without a card every test skips (a CUDA kernel has no interpret mode).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stylish_tts_tpu_torch.ops import spec_conv as sc
from stylish_tts_tpu_torch.ops import stft as plain
from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward

# (n_fft, hop, win): the generator's prior STFT, then the loss resolutions
SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
          (2048, 240, 1200), (2048, 300, 1200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ with no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_kernel_matches_plain(cuda, n_fft, hop, win):
    # lengths that are no multiple of the hop, and a partial last tile
    t = 37 * hop + 3 * n_fft + 11
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, t))
                         .astype(np.float32)).cuda()
    before = stft_forward.launches
    real, imag = stft_forward(x, n_fft=n_fft, hop_length=hop, win_length=win)
    torch.cuda.synchronize()
    assert stft_forward.launches == before + 1
    r0, i0 = plain.stft(x, n_fft=n_fft, hop_length=hop, win_length=win)
    for got, want in ((real, r0), (imag, i0)):
        assert got.shape == want.shape
        # f32 sums of up to win products in another order
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4096, device="cuda")
    kw = dict(n_fft=2048, hop_length=75, win_length=1200)
    with pytest.raises(TypeError):
        stft_forward(x.double(), **kw)
    with pytest.raises(ValueError):
        stft_forward(x[:, ::2], **kw)  # not contiguous
    with pytest.raises(ValueError):
        stft_forward(x[:, :1000].contiguous(), **kw)  # T <= n_fft / 2
    with pytest.raises(ValueError):
        stft_forward(x[:, None], **kw)  # rank 3
    # an input that requires a gradient runs the kernel forward
    before = stft_forward.launches
    real, imag = stft_forward(x[:, :4096].clone().requires_grad_(), **kw)
    (real.sum() + imag.sum()).backward()
    assert stft_forward.launches == before + 1


# (H, W, kt, stride): the MRD's layer kinds at small, odd sizes that leave
# partial tiles on both axes
CONV_SHAPES = [(19, 141, 9, 2), (19, 140, 9, 2), (11, 77, 3, 1),
               (11, 70, 9, 1), (7, 67, 3, 2)]


def _conv_inputs(h, w, kt, stride, seed=0):
    rng = np.random.default_rng(seed)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32)).bfloat16().cuda()

    x = bf16(2, h, w, 32)
    wt = bf16(32, 32, 3, kt, scale=(3 * kt * 32) ** -0.5)
    b = bf16(32, scale=0.1)
    d = bf16(2, h, sc.out_width(w, stride), 32)
    return x, wt, b, d


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,kt,stride", CONV_SHAPES)
def test_spec_conv_kernels_match_plain(cuda, h, w, kt, stride):
    x, wt, b, d = _conv_inputs(h, w, kt, stride)
    counts = [k.launches for k in sc.KERNELS]
    y = sc.spec_conv_forward(x, wt, b, stride, 0.1)
    dx = sc.spec_conv_dgrad(d, wt, w, stride)
    dw = sc.spec_conv_wgrad(x, d, kt, stride)
    torch.cuda.synchronize()
    assert [k.launches for k in sc.KERNELS] == [n + 1 for n in counts]
    # bf16 outputs: f32 sums in another order, then one bf16 rounding
    assert _rel_err(y, sc.forward_plain(x, wt, b, stride, 0.1)) <= 1e-2
    assert _rel_err(dx, sc.dgrad_plain(d, wt, w, stride)) <= 1e-2
    # f32 output: sums of up to 2*19*71 bf16 products in another order
    assert _rel_err(dw, sc.wgrad_plain(x, d, kt, stride)) <= 1e-3


@pytest.mark.cuda
def test_spec_conv_autograd_runs_the_kernels(cuda):
    x, wt, b, _ = _conv_inputs(19, 141, 9, 2, seed=1)
    x.requires_grad_()
    wt.requires_grad_()
    b.requires_grad_()
    before = [k.launches for k in sc.KERNELS]
    y = sc.spec_conv2d(x, wt, b, 2, 0.1)
    y.float().square().sum().backward()
    assert [k.launches for k in sc.KERNELS] == [n + 1 for n in before]
    assert x.grad.shape == x.shape and wt.grad.shape == wt.shape
    assert torch.isfinite(x.grad.float()).all()


@pytest.mark.cuda
def test_spec_conv_refuses_what_it_does_not_take(cuda):
    x, wt, b, d = _conv_inputs(5, 40, 9, 2)
    with pytest.raises(TypeError):
        sc.spec_conv_forward(x.float(), wt, b, 2, 0.1)
    with pytest.raises(ValueError):  # not channels-last contiguous
        sc.spec_conv_forward(x.transpose(1, 2), wt, b, 2, 0.1)
    with pytest.raises(ValueError):  # a CPU weight with a CUDA input
        sc.spec_conv_forward(x, wt.cpu(), b, 2, 0.1)
    with pytest.raises(ValueError):
        sc.spec_conv_forward(x, wt, b, 3, 0.1)
    with pytest.raises(ValueError):
        sc.spec_conv_dgrad(d, wt, 37, 2)  # width 37 gives 19 columns, not 20
    with pytest.raises(ValueError):
        sc.spec_conv_wgrad(x, d[:, :, :-1].contiguous(), 9, 2)

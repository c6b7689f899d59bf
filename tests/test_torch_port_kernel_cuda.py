"""The Hopper STFT kernel against its plain version, on the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_kernel_cuda.py

Without a card every test skips (a CUDA kernel has no interpret mode).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
    with pytest.raises(RuntimeError, match="no gradient"):
        stft_forward(x.requires_grad_(), **kw)

"""The Hopper kernels (STFT; the MRD's spec-conv forward, dgrad and
wgrad; the eight patch-staging probes) against their plain versions, on
the card.

Imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_kernel_cuda.py

Without a card every test skips (a CUDA kernel has no interpret mode).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stylish_tts_tpu_torch.ops import patch_probe as pp
from stylish_tts_tpu_torch.ops import spec_conv as sc
from stylish_tts_tpu_torch.ops import stft as plain
from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward
from torch_port_stft_oracle import rfft_frames

# (n_fft, hop, win): the generator's prior STFT, then the loss resolutions
SHAPES = [(2048, 75, 1200), (512, 50, 240), (1024, 120, 600),
          (2048, 240, 1200), (2048, 300, 1200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ with no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32


def _kernel_input(case: str, n_fft: int, hop: int):
    """(B, T) of one case: a length that is no multiple of the hop; B = 1;
    T just above n_fft/2, so the padded signal is mostly reflection; a
    frame count one past a multiple of the kernel's frames per block, so
    its last block is partial."""
    if case == "b3":
        return 3, 37 * hop + 3 * n_fft + 11
    if case == "b1":
        return 1, 37 * hop + 3 * n_fft + 11
    if case == "short":
        return 2, n_fft // 2 + 1
    per_block = 256 // (n_fft // 16)
    blocks = n_fft // (per_block * hop) + 3
    return 2, blocks * per_block * hop + hop // 2


# the DFT path's frames a block (csrc/stft.cu: DFT_FPB)
DFT_FPB = 128


@pytest.mark.cuda
@pytest.mark.parametrize("batch,t", [
    (8, 138000),                 # the ringformer step's magphase target
    (1, 9201 * 15 + 7),          # one row, no multiple of the hop
    (2, DFT_FPB * 15 * 3),       # the last block holds one frame
    (2, 31)])                    # just above n_fft / 2: mostly reflection
def test_dft_path_matches_plain(cuda, batch, t):
    """The STFT kernel's DFT path at the ringformer's 60/15/60 against the
    plain version and a float64 rfft, launched once."""
    n_fft = win = 60
    hop = 15
    x_np = np.random.default_rng(1).standard_normal((batch, t)) \
        .astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    before = stft_forward.launches_by_n_fft.get(60, 0)
    real, imag = stft_forward(x, n_fft=n_fft, hop_length=hop, win_length=win)
    torch.cuda.synchronize()
    assert stft_forward.launches_by_n_fft[60] == before + 1
    r0, i0 = plain.stft(x, n_fft=n_fft, hop_length=hop, win_length=win)
    ref = rfft_frames(x_np[:, :min(t, 4096)], n_fft, hop, win) \
        if t <= 4096 else None
    for got, want in ((real, r0), (imag, i0)):
        assert got.shape == want.shape == (batch, 1 + t // hop, 31)
        # f32 sums of 59 products in another order
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    if ref is not None:
        assert np.abs(real.cpu().numpy() - ref.real).max() <= \
            1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b3", "b1", "short", "partial"])
@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_kernel_matches_plain(cuda, n_fft, hop, win, case):
    batch, t = _kernel_input(case, n_fft, hop)
    x_np = np.random.default_rng(0).standard_normal((batch, t)) \
        .astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    before = stft_forward.launches
    real, imag = stft_forward(x, n_fft=n_fft, hop_length=hop, win_length=win)
    torch.cuda.synchronize()
    assert stft_forward.launches == before + 1
    if case == "partial":
        assert real.shape[1] % (256 // (n_fft // 16)) == 1
    r0, i0 = plain.stft(x, n_fft=n_fft, hop_length=hop, win_length=win)
    ref = rfft_frames(x_np, n_fft, hop, win)
    for got, want, exact in ((real, r0, ref.real), (imag, i0, ref.imag)):
        assert got.shape == want.shape == exact.shape
        # f32 sums of up to win products in another order (the plain
        # version), and an f32 FFT against a float64 one
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
        err = np.abs(got.cpu().numpy() - exact).max()
        assert err <= 1e-4 * np.abs(exact).max(), err


def _within_one_f32_rounding(table: np.ndarray, exact: np.ndarray) -> bool:
    """(real, imag) columns of ``table`` within half an f32 ulp of ``exact``,
    plus 1e-15 for float64's own error in the cosine and sine (the values
    near 0, such as cos(π/2), are below f32's ulp of 1 by far)."""
    ok = True
    for got, want in ((table[:, 0], exact.real), (table[:, 1], exact.imag)):
        half_ulp = np.spacing(np.abs(want).astype(np.float32)) / 2
        ok &= bool(np.all(np.abs(got.astype(np.float64) - want)
                          <= half_ulp + 1e-15))
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_twiddle_table_is_rounded_once(cuda, n_fft):
    # csrc/stft.cu makes and lays out the table: entry i is e^{-2πi p_i/N}
    exponent, table = stft_forward.twiddles(n_fft)
    assert table.dtype == np.float32 and table.shape == (len(exponent), 2)
    assert _within_one_f32_rounding(
        table, np.exp(-2j * np.pi * exponent.astype(np.float64) / n_fft))
    assert exponent.min() >= 0 and exponent.max() < n_fft
    # the unpacking's e^{-2πik/N}, k = 0..N/4, come first; then each
    # Stockham pass's rows r = 1..R-1 of e^{-2πi r k/(size R)},
    # k = 0..size-1: the pass at size 8 (radix 8) starts with r = 1, 2
    pairs = n_fft // 4 + 1
    np.testing.assert_array_equal(exponent[:pairs], np.arange(pairs))
    step = n_fft // 64
    np.testing.assert_array_equal(exponent[pairs:pairs + 16],
                                  np.r_[np.arange(8), 2 * np.arange(8)] * step)
    # radix 8 while it fits, then one pass of 4 or 2: 512 = 2 * 8 * 8 * 4
    # (rows 7*8 + 3*64), 1024 = 2 * 8 * 8 * 8 (7*8 + 7*64), 2048 =
    # 2 * 8 * 8 * 8 * 2 (7*8 + 7*64 + 1*512)
    assert len(exponent) == pairs + {512: 248, 1024: 504, 2048: 1016}[n_fft]


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
    with pytest.raises(ValueError):  # n_fft not a power of two
        stft_forward(x, n_fft=1200, hop_length=75, win_length=1200)
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


# the persistent forward's tiling (8 output rows a step, up to 4 steps an
# item, strips of 64 positions): (B, H, W, kt, stride)
FWD_TILING = {
    "H not a multiple of the step or the chunk": (2, 77, 141, 9, 2),
    "H below one step": (2, 3, 141, 9, 2),
    "partial last strip": (2, 19, 150, 9, 2),  # W_out 75: 64 + 11
    "W_out below one strip": (2, 19, 9, 9, 2),  # W_out 5
    "B = 1": (1, 19, 141, 9, 2),
    "kt 9 stride 1": (2, 21, 100, 9, 1),
    "kt 3 stride 2": (2, 21, 100, 3, 2),
    "kt 3 stride 1": (2, 21, 100, 3, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FWD_TILING))
def test_spec_conv_forward_tiling(cuda, case):
    batch, h, w, kt, stride = FWD_TILING[case]
    x, wt, b, _ = _conv_inputs(h, w, kt, stride, seed=3)
    x = x[:1].contiguous() if batch == 1 else x
    before = sc.spec_conv_forward.launches
    y = sc.spec_conv_forward(x, wt, b, stride, 0.1)
    torch.cuda.synchronize()
    assert sc.spec_conv_forward.launches == before + 1
    want = sc.forward_plain(x, wt, b, stride, 0.1)
    assert y.shape == want.shape
    assert _rel_err(y, want) <= 1e-2


@pytest.mark.cuda
def test_spec_conv_forward_many_items_per_block(cuda):
    # the MRD's largest layer: every persistent block walks many items
    shape, kt, stride = (8, 257, 2761, 32), 9, 2
    plan = sc.spec_conv_forward.plan(*shape[:3], kt, stride)
    assert plan["items"] >= 8 * plan["blocks"], plan
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn((32, 32, 3, kt), generator=gen, device="cuda")
          * (3 * kt * 32) ** -0.5).bfloat16()
    b = (0.1 * torch.randn(32, generator=gen, device="cuda")).bfloat16()
    y = sc.spec_conv_forward(x, wt, b, stride, 0.1)
    assert _rel_err(y, sc.forward_plain(x, wt, b, stride, 0.1)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kt,stride", [(9, 2), (3, 1)])
def test_spec_conv_forward_is_deterministic(cuda, kt, stride):
    x, wt, b, _ = _conv_inputs(37, 301, kt, stride, seed=5)
    first = sc.spec_conv_forward(x, wt, b, stride, 0.1)
    second = sc.spec_conv_forward(x, wt, b, stride, 0.1)
    assert torch.equal(first, second)


# the persistent wgrad's tiling (4 output rows a step at kt 9, 2 at kt 3,
# up to 32 rows an item, strips of 64 positions): the forward's cases
WGRAD_TILING = dict(FWD_TILING)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGRAD_TILING))
def test_spec_conv_wgrad_tiling(cuda, case):
    batch, h, w, kt, stride = WGRAD_TILING[case]
    x, _, _, d = _conv_inputs(h, w, kt, stride, seed=6)
    if batch == 1:
        x, d = x[:1].contiguous(), d[:1].contiguous()
    before = sc.spec_conv_wgrad.launches
    dw = sc.spec_conv_wgrad(x, d, kt, stride)
    torch.cuda.synchronize()
    assert sc.spec_conv_wgrad.launches == before + 1
    want = sc.wgrad_plain(x, d, kt, stride)
    assert dw.shape == want.shape
    # f32 sums of up to 2 * 77 * 71 bf16 products in another order
    assert _rel_err(dw, want) <= 1e-3


@pytest.mark.cuda
def test_spec_conv_wgrad_many_items_per_block(cuda):
    # the MRD's largest layer: every persistent block walks many items
    shape, kt, stride = (8, 257, 2761, 32), 9, 2
    plan = sc.spec_conv_wgrad.plan(*shape[:3], kt, stride)
    assert plan["items"] >= 8 * plan["blocks"], plan
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    d = torch.randn((8, 257, sc.out_width(2761, stride), 32), generator=gen,
                    device="cuda").bfloat16()
    dw = sc.spec_conv_wgrad(x, d, kt, stride)
    assert _rel_err(dw, sc.wgrad_plain(x, d, kt, stride)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kt,stride", [(9, 2), (3, 1)])
def test_spec_conv_wgrad_is_deterministic(cuda, kt, stride):
    x, _, _, d = _conv_inputs(37, 301, kt, stride, seed=8)
    first = sc.spec_conv_wgrad(x, d, kt, stride)
    second = sc.spec_conv_wgrad(x, d, kt, stride)
    assert torch.equal(first, second)


# the persistent dgrad's tiling (8 dx rows a step, up to 4 steps an item,
# strips of 64 d positions, two parity classes at stride 2): the forward's
# cases, and odd widths whose W_out ends on a strip's edge or one past it
DGRAD_TILING = dict(FWD_TILING)
DGRAD_TILING["odd W, W_out one strip"] = (2, 19, 127, 9, 2)  # W_out 64
DGRAD_TILING["odd W, W_out one past a strip"] = (2, 19, 129, 9, 2)  # 65


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DGRAD_TILING))
def test_spec_conv_dgrad_tiling(cuda, case):
    batch, h, w, kt, stride = DGRAD_TILING[case]
    _, wt, _, d = _conv_inputs(h, w, kt, stride, seed=9)
    d = d[:1].contiguous() if batch == 1 else d
    before = sc.spec_conv_dgrad.launches
    dx = sc.spec_conv_dgrad(d, wt, w, stride)
    torch.cuda.synchronize()
    assert sc.spec_conv_dgrad.launches == before + 1
    want = sc.dgrad_plain(d, wt, w, stride)
    assert dx.shape == want.shape
    assert _rel_err(dx, want) <= 1e-2


@pytest.mark.cuda
def test_spec_conv_dgrad_many_items_per_block(cuda):
    # the MRD's largest layer: every persistent block walks many items
    shape, kt, stride = (8, 257, 2761, 32), 9, 2
    plan = sc.spec_conv_dgrad.plan(*shape[:3], kt, stride)
    assert plan["items"] >= 8 * plan["blocks"], plan
    gen = torch.Generator(device="cuda").manual_seed(11)
    wt = (torch.randn((32, 32, 3, kt), generator=gen, device="cuda")
          * (3 * kt * 32) ** -0.5).bfloat16()
    d = torch.randn((8, 257, sc.out_width(2761, stride), 32), generator=gen,
                    device="cuda").bfloat16()
    dx = sc.spec_conv_dgrad(d, wt, 2761, stride)
    assert _rel_err(dx, sc.dgrad_plain(d, wt, 2761, stride)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kt,stride", [(9, 2), (3, 1)])
def test_spec_conv_dgrad_is_deterministic(cuda, kt, stride):
    _, wt, _, d = _conv_inputs(37, 301, kt, stride, seed=10)
    first = sc.spec_conv_dgrad(d, wt, 301, stride)
    second = sc.spec_conv_dgrad(d, wt, 301, stride)
    assert torch.equal(first, second)


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


def _probe_inputs(kernel, rows, seed=0):
    """The kernel's inputs on the card: rows of output, the probe script's
    widths."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32)).cuda()

    if kernel is pp.mini_kernel:
        return f32(2, 5, rows + 8, 128), f32(1728, 128, scale=0.1)
    if kernel is pp.concat_lane_off:
        return (f32(rows + 6, 64),)
    if kernel in (pp.matmul_after_concat, pp.matmul_after_scratch):
        return f32(rows + 6, 32), f32(192, 128)
    return (f32(rows + 6, 32),)


def _probe_plain(kernel, *inputs):
    if kernel is pp.mini_kernel:
        return pp.mini_plain(*inputs)
    if kernel in (pp.matmul_after_concat, pp.matmul_after_scratch):
        return pp.matmul_plain(*inputs)
    return kernel.plain(*inputs)


# rows of output: the probe's 256; 96, three of the old 32-row blocks; 32,
# one of them; and, for the copies #4-8 and the products #9-10, 131072,
# where P (100.7 MB) is larger than the L2 and #9's blocks walk many row
# tiles each; 160, five 32-row blocks, for #8 and #10; 8192 for the mini
# kernel #11, whose blocks then walk 96 row tiles each
PROBE_ROWS = [(k, rows) for rows in (256, 96, 32) for k in pp.KERNELS] + [
    (k, 131072) for k in pp.KERNELS if k is not pp.mini_kernel] + [
    (pp.dma_assemble, 160), (pp.matmul_after_scratch, 160),
    (pp.mini_kernel, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kernel,rows", PROBE_ROWS,
    ids=[f"{k.name}-{rows}" for k, rows in PROBE_ROWS])
def test_probe_kernels_match_plain(cuda, kernel, rows):
    inputs = _probe_inputs(kernel, rows)
    before = kernel.launches
    got = kernel(*inputs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = _probe_plain(kernel, *inputs)
    assert got.shape == want.shape
    if kernel.n_ptrs == 2:  # #4-8 move data only
        assert torch.equal(got, want)
    else:  # f32 sums of 192 or 1728 products in another order
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


# #10's blocks of a column walk its row tiles, as many blocks as the card
# holds; the grid never has more blocks than tiles, so none goes without.
# Its 32-row tile takes over where its blocks fill the card (88 KB of
# shared memory a block: 2 an SM, 66 a column on 132 SMs): at 67 and 265 of
# them every block walks one or more tiles, and the last step of the walk
# is taken by some blocks only.
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32 * 67, 32 * 265])
def test_probe_matmul_after_scratch_walks_the_row_tiles(cuda, rows):
    x, w = _probe_inputs(pp.matmul_after_scratch, rows)
    got = pp.matmul_after_scratch(x, w)
    want = pp.matmul_plain(x, w)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256, 131072])
def test_probe_matmul_after_scratch_is_deterministic(cuda, rows):
    inputs = _probe_inputs(pp.matmul_after_scratch, rows)
    first = pp.matmul_after_scratch(*inputs)
    again = pp.matmul_after_scratch(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# #11's blocks keep 16 columns of w resident (210 KB of shared memory: one
# an SM, 16 a column on 132 SMs) and walk row tiles of 64 rows, the last of
# each (b, f) a half tile where R is an odd multiple of 32: B F ceil(R / 64)
# of them.  At R = 160 (18 tiles, 3 a (b, f)) and R = 1440 (138, 23 a
# (b, f)) the last step of the walk is taken by some blocks only.
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [160, 1440])
def test_probe_mini_kernel_walks_the_row_tiles(cuda, rows):
    xq, w = _probe_inputs(pp.mini_kernel, rows)
    got = pp.mini_kernel(xq, w)
    want = pp.mini_plain(xq, w)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512, 8192])
def test_probe_mini_kernel_is_deterministic(cuda, rows):
    inputs = _probe_inputs(pp.mini_kernel, rows)
    first = pp.mini_kernel(*inputs)
    again = pp.mini_kernel(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", pp.KERNELS, ids=lambda k: k.name)
def test_probe_kernels_refuse_what_they_do_not_take(cuda, kernel):
    inputs = _probe_inputs(kernel, 64)
    first, rest = inputs[0], inputs[1:]
    with pytest.raises(TypeError):  # not f32
        kernel(first.double(), *rest)
    with pytest.raises(ValueError):  # not contiguous
        kernel(first.transpose(-1, -2).contiguous().transpose(-1, -2), *rest)
    with pytest.raises(ValueError):  # 63 output rows, or a wrong width
        kernel(first[..., :-1, :].contiguous(), *rest)
    with pytest.raises(ValueError):
        kernel(first[..., :-1].contiguous(), *rest)
    if rest:  # a CPU weight with a CUDA input
        with pytest.raises(ValueError):
            kernel(first, rest[0].cpu())
    before = kernel.launches
    kernel(*inputs)
    assert kernel.launches == before + 1

"""The timing cases of ``scripts/probe_times.py`` on the CPU: which kernels
each size times, the FLOP and bytes its bounds rest on, and that each
library call computes what the kernel's plain version does."""

from __future__ import annotations

import pytest
import torch

from stylish_tts_tpu_torch.ops import patch_probe as pp
from stylish_tts_tpu_torch.scripts import mosaic_probe as mp
from stylish_tts_tpu_torch.scripts import probe_times as pt

CPU = torch.device("cpu")
COPIES = (pp.concat_full_lane, pp.concat_lane_off, pp.scratch_write,
          pp.stack_reshape, pp.dma_assemble)
PRODUCTS = (pp.matmul_after_concat, pp.matmul_after_scratch)


SIZES = (256, 1024, pt.LARGE_T)


@pytest.fixture(scope="module")
def cases():
    return {t: pt.probe_cases(CPU, t) for t in SIZES}


def sizes(kernel, t: int):
    """(FLOP, bytes) of one kernel's function at ``t`` rows of P, in closed
    form: every input read once, the output written once, f32."""
    if kernel is pp.mini_kernel:  # xq [2, 5, R + 8, 128], w [1728, 128]
        rows = 512 if t == 256 else 8192
        out = 2 * 3 * rows * 128
        return 2.0 * out * 1728, 4.0 * (2 * 5 * (rows + 8) * 128
                                        + 1728 * 128 + out)
    if kernel in PRODUCTS:
        return 2.0 * t * 192 * 128, 4.0 * ((t + 6) * 32 + 192 * 128 + t * 128)
    width = 64 if kernel is pp.concat_lane_off else 32
    return 0.0, 4.0 * ((t + 6) * width + t * 192)


@pytest.mark.parametrize("t", SIZES)
def test_each_size_times_its_kernels(cases, t):
    want = COPIES + PRODUCTS + ((pp.mini_kernel,) if t != 1024 else ())
    assert set(cases[t]) == set(want)
    assert list(cases[t]) == [k for k in pp.KERNELS if k in want]


@pytest.mark.parametrize("t", SIZES)
def test_flops_and_bytes_match_the_closed_forms(cases, t):
    for kernel, case in cases[t].items():
        assert (case.flops, case.nbytes) == sizes(kernel, t), kernel.name


LIBRARY = [(256, k) for k in pp.KERNELS] + [
    (1024, k) for k in pp.KERNELS if k is not pp.mini_kernel]


@pytest.mark.parametrize("t,kernel", LIBRARY,
                         ids=[f"{t}-{k.name}" for t, k in LIBRARY])
def test_library_call_equals_the_plain_version(cases, t, kernel):
    case = cases[t][kernel]
    want = case.plain(*case.inputs)
    got = case.as_plain(case.library())
    assert got.shape == want.shape
    if case.flops == 0:  # a copy
        assert torch.equal(got, want)
    else:  # f32 sums of 192 or 1728 products in another order
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), err


def test_the_mini_kernels_inputs_and_bounds(cases):
    """The probe script's inputs at R = 512; at R = 8192 operations still
    set the bound."""
    xq, w = cases[256][pp.mini_kernel].inputs
    assert tuple(xq.shape) == (2, 5, 520, 128)
    want = [torch.from_numpy(a) for a in mp.mini_inputs()]
    assert torch.equal(xq, want[0]) and torch.equal(w, want[1])
    assert tuple(cases[pt.LARGE_T][pp.mini_kernel].inputs[0].shape) == (
        2, 5, 8200, 128)

    probe = pt.Case((), None, None, None, *sizes(pp.mini_kernel, 256))
    assert probe.flops == pytest.approx(1.359e9, rel=1e-3)
    bound, by = probe.bound()
    assert by == "operations" and bound * 1e3 == pytest.approx(20.28, abs=5e-3)
    large = pt.Case((), None, None, None,
                    *sizes(pp.mini_kernel, pt.LARGE_T))
    assert large.flops == pytest.approx(21.74e9, rel=1e-3)
    assert large.nbytes == pytest.approx(68.0e6, rel=1e-3)
    bound, by = large.bound()
    assert by == "operations" and bound * 1e3 == pytest.approx(324.5, abs=0.05)
    assert large.nbytes / pt.PEAK_BYTES * 1e6 == pytest.approx(20.3, abs=0.05)


def test_the_products_bounds():
    at_256 = pt.Case((), None, None, None, *sizes(pp.matmul_after_concat, 256))
    assert (at_256.flops, at_256.nbytes) == (12_582_912, 262_912)
    bound, by = at_256.bound()
    assert by == "operations" and bound * 1e3 == pytest.approx(0.188, abs=5e-4)

    large = pt.Case((), None, None, None,
                    *sizes(pp.matmul_after_concat, pt.LARGE_T))
    assert large.flops == pytest.approx(6.44e9, rel=1e-3)
    assert large.nbytes == pytest.approx(84.0e6, rel=1e-3)
    bound, by = large.bound()
    assert by == "operations" and bound * 1e3 == pytest.approx(96.2, abs=0.05)
    assert large.nbytes / pt.PEAK_BYTES * 1e6 == pytest.approx(25.1, abs=0.05)
    # the copies at the large T stay set by bytes
    copy = pt.Case((), None, None, None, *sizes(pp.scratch_write, pt.LARGE_T))
    bound, by = copy.bound()
    assert by == "bytes" and bound * 1e3 == pytest.approx(35.06, abs=0.01)

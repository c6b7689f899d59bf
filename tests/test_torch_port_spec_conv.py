"""The MRD's spec-conv op of the port (plain versions and the autograd
op, on the CPU) against the JAX package's Pallas kernel in interpret mode
and its lax reference: forward and the VJP (dx, dW, db)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.ops.spec_conv import (pack_freq, spec_conv2d_packed,
                                           spec_conv2d_reference, unpack_freq)
from stylish_tts_tpu_torch.ops import spec_conv as sc

# (H, W, kt, stride): odd and even sizes, both strides, both tap counts
CONFIGS = [(5, 33, 9, 2), (4, 20, 9, 1), (5, 17, 3, 1), (9, 31, 3, 2)]


def _inputs(h, w, kt, stride, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, h, w, 32)).astype(np.float32)
    wt = (rng.standard_normal((3, kt, 32, 32)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(32) * 0.1).astype(np.float32)
    g = rng.standard_normal((1, h, -(-w // stride), 32)).astype(np.float32)
    return x, wt, b, g


def _port(x, wt, b, g, stride, dtype):
    """y and (dx, dW in flax layout, db) of the port's autograd op."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wtt = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).to(dtype) \
        .requires_grad_()
    bt = torch.from_numpy(b).to(dtype).requires_grad_()
    y = sc.spec_conv2d(xt, wtt, bt, stride, 0.1)
    (y.float() * torch.from_numpy(g)).sum().backward()
    f = lambda t: t.detach().float().numpy()  # noqa: E731
    return f(y), (f(xt.grad), f(wtt.grad).transpose(2, 3, 1, 0), f(bt.grad))


def _jax_vjp(fn, args, g):
    """y and the VJP of ``fn`` at ``args`` for cotangent ``g``, under one
    jit (the Pallas interpreter traced once runs faster than eagerly)."""
    def both(args, g):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)
    return jax.jit(both)(args, g)


def _close(port, ref, rel, what):
    err = float(np.max(np.abs(port - np.asarray(ref, np.float32))))
    bound = rel * float(np.max(np.abs(ref)))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("h,w,kt,stride", CONFIGS)
def test_plain_forward_and_vjp_match_pallas_kernel(h, w, kt, stride):
    x, wt, b, g = _inputs(h, w, kt, stride, seed=h * w)

    def packed(x, wt, b):
        yq = spec_conv2d_packed(pack_freq(x), wt, b, h, stride, 0.1, True)
        return unpack_freq(yq, h, 32)

    def reference(x, wt, b):
        return spec_conv2d_reference(x, wt, b, stride, 0.1)

    y, grads = _port(x, wt, b, g, stride, torch.float32)
    # the TPU kernel takes stride 2 only at kt 9, the MRD's only stride-2 case
    refs = [("reference", reference)]
    if not (stride == 2 and kt == 3):
        refs.append(("pallas", packed))
    for name, fn in refs:
        y_j, grads_j = _jax_vjp(fn, tuple(map(jnp.asarray, (x, wt, b))),
                                jnp.asarray(g))
        # f32 on both sides, sums of up to 3*9*32 products (dx, dW: of up to
        # H*W_out*32) in another order
        _close(y, y_j, 1e-5, f"{name} y")
        for label, got, want in zip(("dx", "dW", "db"), grads, grads_j):
            _close(got, want, 1e-5, f"{name} {label}")


def test_bf16_op_matches_pallas_kernel_loosely():
    h, w, kt, stride = 5, 21, 9, 2
    x, wt, b, g = _inputs(h, w, kt, stride, seed=5)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    x, wt, b = bf(x), bf(wt), bf(b)

    def packed(x, wt, b):
        yq = spec_conv2d_packed(pack_freq(x), wt, b, h, stride, 0.1, True)
        return unpack_freq(yq, h, 32)

    y, grads = _port(x, wt, b, g, stride, torch.bfloat16)
    y_j, grads_j = _jax_vjp(
        packed, tuple(jnp.asarray(a, jnp.bfloat16) for a in (x, wt, b)),
        jnp.asarray(g, jnp.bfloat16))
    # bf16 outputs and gradients: one bf16 rounding (2^-8 relative) on
    # each side, of values summed in another order
    _close(y, np.asarray(y_j, np.float32), 1e-2, "bf16 y")
    for label, got, want in zip(("dx", "dW", "db"), grads, grads_j):
        _close(got, np.asarray(want, np.float32), 2e-2, f"bf16 {label}")


def test_autograd_op_matches_autograd_of_the_plain_forward():
    x, wt, b, g = _inputs(6, 25, 9, 2, seed=9)
    y, grads = _port(x, wt, b, g, 2, torch.float32)
    xt, wtt, bt = (torch.from_numpy(a).requires_grad_()
                   for a in (x, wt.transpose(3, 2, 0, 1).copy(), b))
    y2 = sc.forward_plain(xt, wtt, bt, 2, 0.1)
    (y2 * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y, y2.detach().numpy())
    want = (xt.grad.numpy(), wtt.grad.numpy().transpose(2, 3, 1, 0),
            bt.grad.numpy())
    for label, got, ref in zip(("dx", "dW", "db"), grads, want):
        _close(got, ref, 1e-6, label)  # the same f32 conv, summed anew


def test_backward_computes_only_what_is_needed():
    x, wt, b, _ = _inputs(5, 20, 3, 1, seed=2)
    xt = torch.from_numpy(x)  # no gradient: the discriminator view
    wtt = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    sc.spec_conv2d(xt, wtt, bt, 1, 0.1).sum().backward()
    assert xt.grad is None and wtt.grad is not None and bt.grad is not None


@pytest.mark.parametrize("kt", [9, 3])
def test_pack_weights_gmma_unpacks_by_index(kt):
    # the forward's wgmma slabs [3, kt, 2 channel halves h, 4 groups u,
    # 2 k halves v, 8 rows r, 8 e]: output channel n = 8u + r, input
    # channel k = 16h + 8v + e
    w = torch.from_numpy(np.random.default_rng(kt + 1).standard_normal(
        (32, 32, 3, kt)).astype(np.float32))
    packed = sc.pack_weights_gmma(w).numpy()
    assert packed.shape == (3, kt, 2, 4, 2, 8, 8)
    back = np.full((32, 32, 3, kt), np.nan, np.float32)
    for i, j, h, u, v, r, e in np.ndindex(packed.shape):
        back[8 * u + r, 16 * h + 8 * v + e, i, j] = packed[i, j, h, u, v, r, e]
    np.testing.assert_array_equal(back, w.numpy())


def _dgrad_pe(kt, stride):
    """d columns the dgrad's strip window reaches on either side: window
    tap u = 0..2 pe reads d column m + u - pe for dx column stride * m + cls
    (``csrc/spec_conv.cu``: ``Dgr::PE``)."""
    pt = kt // 2
    return (pt + 1) // 2 if stride == 2 else pt


def _dgrad_slab(kt, stride, cls, u):
    """The slab of the dgrad's weight operand (flipped taps j' = kt-1-j)
    that window tap u of parity class ``cls`` multiplies, as the kernel maps
    it (``AllTaps``, ``ClassTaps``); outside [0, kt) the tap misses the
    class."""
    if stride == 1:
        return u
    return 2 * u - cls + kt - 1 - kt // 2 - 2 * _dgrad_pe(kt, stride)


@pytest.mark.parametrize("kt,stride", [(9, 2), (3, 2), (9, 1), (3, 1)])
def test_pack_weights_dgrad_unpacks_by_index(kt, stride):
    # the forward's slabs of w.transpose(0, 1).flip(2, 3): slab (i', j')
    # holds dx channel c = 8u + r and d channel n = 16h + 8v + e of
    # w[n, c, 2 - i', kt - 1 - j']; each class's window tap u reads the
    # original tap j = cls + pt - 2e (e = u - pe) at stride 2, j = kt-1-u
    # at stride 1, and every slab serves exactly one (class, tap)
    w = torch.from_numpy(np.random.default_rng(kt + 7).standard_normal(
        (32, 32, 3, kt)).astype(np.float32))
    packed = sc.pack_weights_dgrad(w).numpy()
    assert packed.shape == (3, kt, 2, 4, 2, 8, 8)
    pt, pe = kt // 2, _dgrad_pe(kt, stride)
    used = []
    for cls in range(stride):
        for u in range(2 * pe + 1):
            slab = _dgrad_slab(kt, stride, cls, u)
            if not 0 <= slab < kt:
                continue
            used.append(slab)
            j = cls + pt - 2 * (u - pe) if stride == 2 else kt - 1 - u
            for i, h, gu, v, r, e in np.ndindex(3, 2, 4, 2, 8, 8):
                assert packed[i, slab, h, gu, v, r, e] == \
                    w[16 * h + 8 * v + e, 8 * gu + r, 2 - i, j]
    assert sorted(used) == list(range(kt))


def _dgrad_by_class(d, w, width, stride):
    """dx the way the dgrad kernel sums it: strips of 64 d positions m, each
    parity class a stride-1 correlation of d (zero past its edges) with its
    own window taps, whose weights come from the packed slabs; column
    stride * m + cls is kept below width."""
    kt = w.shape[-1]
    b, h, w_out, _ = d.shape
    slabs = sc.pack_weights_dgrad(w).permute(0, 1, 2, 4, 6, 3, 5) \
        .reshape(3, kt, 32, 32)  # [i', j', d channel, dx channel]
    strips = -(-w_out // 64)
    pe = _dgrad_pe(kt, stride)
    dp = torch.nn.functional.pad(d, (0, 0, pe, strips * 64 + pe - w_out,
                                     1, 1))
    dx = torch.full((b, h, width, 32), float("nan"))
    for cls in range(stride):
        taps = [(u, s) for u in range(2 * pe + 1)
                for s in [_dgrad_slab(kt, stride, cls, u)] if 0 <= s < kt]
        for m0 in range(0, strips * 64, 64):
            acc = torch.zeros(b, h, 64, 32)
            for i in range(3):
                for u, s in taps:
                    acc += dp[:, i:i + h, m0 + u:m0 + u + 64] @ slabs[i, s]
            cols = stride * (m0 + torch.arange(64)) + cls
            keep = cols < width
            dx[:, :, cols[keep]] = acc[:, :, keep]
    return dx


# (kt, stride, width): even and odd widths, W_out 70 or 71 (a partial
# second strip of 64 d positions)
DGRAD_CLASS_CASES = [(9, 2, 140), (9, 2, 139), (3, 2, 140), (3, 2, 141),
                     (9, 1, 70), (9, 1, 71), (3, 1, 70), (3, 1, 71)]


@pytest.mark.parametrize("kt,stride,width", DGRAD_CLASS_CASES)
def test_dgrad_parity_classes_match_plain(kt, stride, width):
    rng = np.random.default_rng(kt * width + stride)
    d = torch.from_numpy(rng.standard_normal(
        (2, 5, sc.out_width(width, stride), 32)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, 32, 3, kt)) * 0.1)
                         .astype(np.float32))
    got = _dgrad_by_class(d, w, width, stride)
    want = sc.dgrad_plain(d, w, width, stride)
    assert not torch.isnan(got).any()  # every dx column written
    # f32 on both sides, sums of up to 3 * 5 * 32 products in another order
    _close(got.numpy(), want.numpy(), 1e-5, "dx by class")

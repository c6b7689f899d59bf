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

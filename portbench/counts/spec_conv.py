"""The MRD's C=32 convolution's work (from ``chip_smoke.py:
spec_conv_numbers``): leaky_relu(conv(x, w) + b) on channels-last bf16
x [B, H, W, 32], w [32, 32, 3, kt], stride (1, s), W_out = ceil(W / s).
The three kernels' FLOP are the same 2 B H W_out 3 kt 32^2; bytes are each
input read once and each output written once (the wgrad's f32 weight
gradient)."""

from __future__ import annotations

C = 32


def out_width(width: int, stride: int) -> int:
    return -(-width // stride)


def work(kind: str, batch: int, h: int, width: int, kt: int,
         stride: int) -> tuple:
    """(FLOP, bytes) of one launch of ``kind`` (forward, dgrad, wgrad) at
    the layer whose input is [batch, h, width, 32]."""
    w_out = out_width(width, stride)
    x = batch * h * width * C
    d = batch * h * w_out * C
    w = 3 * kt * C * C
    nbytes = {"forward": 2 * (x + w + C + d),
              "dgrad": 2 * (d + w + x),
              "wgrad": 2 * (x + d) + 4 * w}[kind]
    return 2.0 * batch * h * w_out * 3 * kt * C * C, float(nbytes)

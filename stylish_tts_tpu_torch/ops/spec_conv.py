"""The MRD discriminator's C=32 convolutions: Hopper kernels
(``csrc/spec_conv.cu``), their plain versions and the autograd op.

It replaces the TPU kernels of ``stylish_tts_tpu/ops/spec_conv.py``: the
forward (``_fwd_call``, which also serves dx there) and the weight gradient
(``_dw_call``).  The layout is plain channels-last, x ``[B, H, W, 32]`` in
bf16, with torch-layout weights ``[32, 32, 3, kt]`` (kt 9 or 3), zero
padding ``(1, kt // 2)`` and stride ``(1, s)``, s 1 or 2, so
``W_out = ceil(W / s)``.  In the discriminator H is the frequency axis and W
the frame axis.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  The plain versions compute in f32 on the
same bf16 values and round as the kernels do: they are the CPU path and the
card's oracle.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

CHANNELS = 32
KF = 3
_SOURCE = "stylish_tts_tpu_torch/csrc/spec_conv.cu"
_TPU = "stylish_tts_tpu/ops/spec_conv.py"


def out_width(width: int, stride: int) -> int:
    return -(-width // stride)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


# --------------------------------------------------------------------------- #
# plain versions


def forward_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int, leaky: float) -> torch.Tensor:
    """leaky_relu(conv(x, w) + b) in f32 on the bf16 values, rounded to
    bf16: x [B, H, W, 32] -> [B, H, W_out, 32]."""
    kt = w.shape[-1]
    y = F.conv2d(_nchw(x).float(), w.float(), b.float(), stride=(1, stride),
                 padding=(KF // 2, kt // 2))
    return _nhwc(F.leaky_relu(y, leaky)).to(x.dtype)


def dgrad_plain(d: torch.Tensor, w: torch.Tensor, width: int,
                stride: int) -> torch.Tensor:
    """Input gradient from the pre-activation gradient d [B, H, W_out, 32]
    -> [B, H, width, 32], f32 sums rounded to d's type."""
    b, h, _, c = d.shape
    kt = w.shape[-1]
    dx = torch.nn.grad.conv2d_input(
        (b, c, h, width), w.float(), _nchw(d).float(), stride=(1, stride),
        padding=(KF // 2, kt // 2))
    return _nhwc(dx).to(d.dtype)


def wgrad_plain(x: torch.Tensor, d: torch.Tensor, kt: int,
                stride: int) -> torch.Tensor:
    """Weight gradient, f32 ``[32, 32, 3, kt]``."""
    return torch.nn.grad.conv2d_weight(
        _nchw(x).float(), (CHANNELS, CHANNELS, KF, kt), _nchw(d).float(),
        stride=(1, stride), padding=(KF // 2, kt // 2))


# --------------------------------------------------------------------------- #
# the kernels


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[n, k, 3, kt] (torch layout, n the GEMM's output channel and k its
    reduction channel) -> the kernels' MMA-fragment order
    [3, kt, 2, 4, 32 lanes, 4]: lane (g, t) = (lane // 4, lane % 4) of
    channel half h and n-tile u holds k = 16h + (2t, 2t+1, 2t+8, 2t+9) of
    column n = 8u + g."""
    lane = torch.arange(32, device=w.device)
    g, t = lane // 4, lane % 4
    rows = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], -1)
    k = torch.arange(2, device=w.device)[:, None, None, None] * 16 + rows
    n = torch.arange(4, device=w.device)[None, :, None, None] * 8 \
        + g[None, None, :, None]
    w_kkin = w.permute(2, 3, 1, 0)  # [3, kt, k, n]
    return w_kkin[:, :, k, n].contiguous()


def _check(name: str, **tensors: torch.Tensor) -> torch.device:
    device = None
    for label, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, not CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} must be bfloat16, got {t.dtype}")
    return device


def _check_act(name: str, label: str, t: torch.Tensor) -> None:
    if t.dim() != 4 or t.shape[-1] != CHANNELS:
        raise ValueError(f"{name}: {label} must be [B, H, W, {CHANNELS}], "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {label} must be contiguous channels-last "
                         "[B, H, W, C]")


def _check_weight(name: str, w: torch.Tensor, stride: int) -> int:
    if w.dim() != 4 or tuple(w.shape[:3]) != (CHANNELS, CHANNELS, KF) \
            or w.shape[3] not in (3, 9):
        raise ValueError(f"{name}: weight must be [32, 32, 3, 9 or 3], got "
                         f"{tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    return int(w.shape[3])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built library with its three entry points typed."""
    lib = load_library("spec_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spec_conv_forward_bf16.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.spec_conv_dgrad_bf16.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.spec_conv_wgrad_bf16.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    for fn in (lib.spec_conv_forward_bf16, lib.spec_conv_dgrad_bf16,
               lib.spec_conv_wgrad_bf16):
        fn.restype = ctypes.c_int
    return lib


class _Kernel:
    """Launch counter and identity shared by the three wrappers."""

    route = "cuda"
    source = _SOURCE

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0

    def _done(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1


class SpecConvForward(_Kernel):
    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int, leaky: float) -> torch.Tensor:
        """leaky_relu(conv(x, w) + b): x [B, H, W, 32] bf16 ->
        [B, H, ceil(W / stride), 32] bf16."""
        if x.device.type == "cpu":
            return forward_plain(x, w, b, stride, leaky)
        device = _check(self.name, x=x, w=w, b=b)
        _check_act(self.name, "x", x)
        kt = _check_weight(self.name, w, stride)
        if tuple(b.shape) != (CHANNELS,):
            raise ValueError(f"{self.name}: bias must be [32]")
        batch, h, width, _ = x.shape
        w_out = out_width(width, stride)
        packed = pack_weights(w)
        bias = b.float().contiguous()
        y = torch.empty((batch, h, w_out, CHANNELS), dtype=x.dtype,
                        device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _library().spec_conv_forward_bf16(
                x.data_ptr(), packed.data_ptr(), bias.data_ptr(), y.data_ptr(),
                batch, h, width, w_out, kt, stride, float(leaky), stream)
        self._done(err)
        return y


class SpecConvDgrad(_Kernel):
    def __call__(self, d: torch.Tensor, w: torch.Tensor, width: int,
                 stride: int) -> torch.Tensor:
        """Input gradient [B, H, width, 32] bf16 from the pre-activation
        gradient d [B, H, ceil(width / stride), 32] bf16."""
        if d.device.type == "cpu":
            return dgrad_plain(d, w, width, stride)
        device = _check(self.name, d=d, w=w)
        _check_act(self.name, "d", d)
        kt = _check_weight(self.name, w, stride)
        batch, h, w_out, _ = d.shape
        if w_out != out_width(width, stride):
            raise ValueError(f"{self.name}: d has {w_out} columns, width "
                             f"{width} at stride {stride} gives "
                             f"{out_width(width, stride)}")
        packed = pack_weights(w.transpose(0, 1))
        dx = torch.empty((batch, h, width, CHANNELS), dtype=d.dtype,
                         device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _library().spec_conv_dgrad_bf16(
                d.data_ptr(), packed.data_ptr(), dx.data_ptr(), batch, h,
                width, w_out, kt, stride, stream)
        self._done(err)
        return dx


class SpecConvWgrad(_Kernel):
    def __call__(self, x: torch.Tensor, d: torch.Tensor, kt: int,
                 stride: int) -> torch.Tensor:
        """Weight gradient f32 [32, 32, 3, kt] from x [B, H, W, 32] and the
        pre-activation gradient d [B, H, ceil(W / stride), 32], both bf16."""
        if x.device.type == "cpu":
            return wgrad_plain(x, d, kt, stride)
        device = _check(self.name, x=x, d=d)
        _check_act(self.name, "x", x)
        _check_act(self.name, "d", d)
        if kt not in (3, 9) or stride not in (1, 2):
            raise ValueError(f"{self.name}: kt {kt} stride {stride}")
        batch, h, width, _ = x.shape
        w_out = out_width(width, stride)
        if tuple(d.shape) != (batch, h, w_out, CHANNELS):
            raise ValueError(f"{self.name}: d {tuple(d.shape)} does not match "
                             f"x {tuple(x.shape)} at stride {stride}")
        tiles = batch * -(-h // 2) * -(-w_out // 64)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = max(1, min(tiles, 2 * sms))
        partial = torch.empty((blocks, KF * kt * CHANNELS * CHANNELS),
                              dtype=torch.float32, device=device)
        dw = torch.empty((KF, kt, CHANNELS, CHANNELS), dtype=torch.float32,
                         device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _library().spec_conv_wgrad_bf16(
                x.data_ptr(), d.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                batch, h, width, w_out, kt, stride, blocks, stream)
        self._done(err)
        return dw.permute(3, 2, 0, 1)  # [3, kt, in, out] -> [out, in, 3, kt]


spec_conv_forward = SpecConvForward("spec_conv_forward", f"{_TPU}:285")
spec_conv_dgrad = SpecConvDgrad("spec_conv_dgrad", f"{_TPU}:285")
spec_conv_wgrad = SpecConvWgrad("spec_conv_wgrad", f"{_TPU}:375")
KERNELS = (spec_conv_forward, spec_conv_dgrad, spec_conv_wgrad)


def leaky_mask(dy: torch.Tensor, y: torch.Tensor,
               leaky: float) -> torch.Tensor:
    """Gradient at the pre-activation: leaky_relu is monotone, so the sign
    of the saved output is the sign of its input."""
    return dy * torch.where(y >= 0, 1.0, leaky).to(dy.dtype)


class SpecConv2d(torch.autograd.Function):
    """leaky_relu(conv(x, w) + b) whose forward and backward run on the
    kernels (the plain versions on the CPU).  The backward computes only
    the gradients its inputs need."""

    @staticmethod
    def forward(ctx, x, w, b, stride: int, leaky: float):
        y = spec_conv_forward(x, w, b, stride, leaky)
        ctx.save_for_backward(x, w, y)
        ctx.stride, ctx.leaky = stride, leaky
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        d = leaky_mask(dy.contiguous(), y, ctx.leaky)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = spec_conv_dgrad(d, w, x.shape[2], ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = spec_conv_wgrad(x, d, w.shape[-1], ctx.stride).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = d.float().sum(dim=(0, 1, 2)).to(w.dtype)
        return dx, dw, db, None, None


def spec_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int = 1, leaky: float = 0.1) -> torch.Tensor:
    return SpecConv2d.apply(x, w, b, stride, leaky)

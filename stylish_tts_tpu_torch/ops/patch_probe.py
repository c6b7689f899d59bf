"""The patch-staging probes: Hopper kernels (``csrc/patch_probe.cu``) and
their plain versions.

They replace the eight Pallas kernels of ``scripts/mosaic_probe.py``.  Each
builds the patch matrix of six shifted slices of x [T + 6, 32],
``P[t, 32j + c] = x[t + j, c]`` ([T, 192]), by one way of staging data on
Hopper; two multiply it by w [192, 128], and the last is a miniature of the
spec-conv forward.  ``csrc/patch_probe.cu`` says which staging idiom each
kernel tries.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  The plain versions follow the TPU probes'
order (slices concatenated, then one f32 product): they are the CPU path
and the card's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .build import load_library

CIN, TAPS, N = 32, 6, 128
K = TAPS * CIN                  # 192, the patch width
ROWS = 32                       # rows of P per block: T is a multiple of it
MINI_GROUPS = range(3, 9)       # the 32-channel groups the mini kernel reads
MINI_KT = 9                     # its taps on t
MINI_K = len(MINI_GROUPS) * MINI_KT * CIN  # 1728
_SOURCE = "stylish_tts_tpu_torch/csrc/patch_probe.cu"
_TPU = "scripts/mosaic_probe.py"


# --------------------------------------------------------------------------- #
# plain versions


def patches_plain(x: torch.Tensor) -> torch.Tensor:
    """x [T + 6, 32] -> P [T, 192], P[t, 32j + c] = x[t + j, c]."""
    t = x.shape[0] - TAPS
    return torch.cat([x[j:j + t] for j in range(TAPS)], dim=1)


def lane_off_plain(xp: torch.Tensor) -> torch.Tensor:
    """xp [T + 6, 64] -> [T, 192], slice j from columns 32 (j % 2) .. +32."""
    t = xp.shape[0] - TAPS
    return torch.cat([xp[j:j + t, (j % 2) * CIN:(j % 2 + 1) * CIN]
                      for j in range(TAPS)], dim=1)


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P @ w in f32: x [T + 6, 32], w [192, 128] -> [T, 128]."""
    return patches_plain(x) @ w


def mini_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq [B, F + 2, R + 8, 128], w [1728, 128] -> [B, F, R, 128]:
    out[b, f, t] = cat over g = 3..8, dt < 9 of
    xq[b, f + g // 4, t + dt, 32 (g % 4) : +32], times w."""
    fq, rows = xq.shape[1] - 2, xq.shape[2] - (MINI_KT - 1)
    outs = []
    for f in range(fq):
        cols = []
        for g in MINI_GROUPS:
            blk, lane = divmod(g, 4)
            for dt in range(MINI_KT):
                cols.append(xq[:, f + blk, dt:dt + rows,
                               lane * CIN:(lane + 1) * CIN])
        outs.append(torch.cat(cols, dim=-1) @ w)
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------------------- #
# the kernels


def _check(name: str, **tensors: torch.Tensor) -> torch.device:
    device = None
    for label, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, not CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    return device


def _shape(name: str, label: str, t: torch.Tensor, want: Tuple) -> None:
    if t.dim() != len(want) or any(
            w is not None and s != w for s, w in zip(t.shape, want)):
        raise ValueError(f"{name}: {label} must be {want} (None: any), got "
                         f"{tuple(t.shape)}")


def _rows(name: str, n: int) -> int:
    if n <= 0 or n % ROWS:
        raise ValueError(f"{name}: {n} output rows, not a positive multiple "
                         f"of {ROWS}")
    return n


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The built library with its eight entry points typed."""
    lib = load_library("patch_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for k in KERNELS:
        fn = getattr(lib, k.name)
        fn.argtypes = [ptr] * k.n_ptrs + [i32] * k.n_ints + [ptr]
        fn.restype = ctypes.c_int
    return lib


class _Kernel:
    """Identity, launch counter and launch shared by the eight wrappers;
    the C entry point carries the TPU probe's name."""

    route = "cuda"
    source = _SOURCE
    n_ptrs = 2
    n_ints = 1

    def __init__(self, name: str, line: int):
        self.name = name
        self.replaces = f"{_TPU}:{line}"
        self.launches = 0

    def _launch(self, out_shape, inputs: Dict[str, torch.Tensor],
                *ints: int) -> torch.Tensor:
        device = _check(self.name, **inputs)
        out = torch.empty(out_shape, dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(_library(), self.name)(
                *(t.data_ptr() for t in inputs.values()), out.data_ptr(),
                *ints, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return out


class PatchKernel(_Kernel):
    """x [T + 6, width] -> P [T, 192] (#4-8)."""

    def __init__(self, name: str, line: int, width: int, plain):
        super().__init__(name, line)
        self.width = width
        self.plain = plain

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        _shape(self.name, "x", x, (None, self.width))
        t = _rows(self.name, x.shape[0] - TAPS)
        return self._launch((t, K), {"x": x}, t)


class MatmulKernel(_Kernel):
    """x [T + 6, 32], w [192, 128] -> P @ w [T, 128] (#9-10)."""

    n_ptrs = 3

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return matmul_plain(x, w)
        _shape(self.name, "x", x, (None, CIN))
        _shape(self.name, "w", w, (K, N))
        t = _rows(self.name, x.shape[0] - TAPS)
        return self._launch((t, N), {"x": x, "w": w}, t)


class MiniKernel(_Kernel):
    """xq [B, F + 2, R + 8, 128], w [1728, 128] -> [B, F, R, 128] (#11)."""

    n_ptrs = 3
    n_ints = 3

    def __call__(self, xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if xq.device.type == "cpu":
            return mini_plain(xq, w)
        _shape(self.name, "xq", xq, (None, None, None, 4 * CIN))
        _shape(self.name, "w", w, (MINI_K, N))
        batch, fq = xq.shape[0], xq.shape[1] - 2
        rows = _rows(self.name, xq.shape[2] - (MINI_KT - 1))
        if batch <= 0 or fq <= 0:
            raise ValueError(f"{self.name}: xq {tuple(xq.shape)} has no "
                             "output")
        return self._launch((batch, fq, rows, N), {"xq": xq, "w": w},
                            batch, fq, rows)


concat_full_lane = PatchKernel("probe_concat_full_lane", 50, CIN,
                               patches_plain)
concat_lane_off = PatchKernel("probe_concat_lane_off", 63, 2 * CIN,
                              lane_off_plain)
scratch_write = PatchKernel("probe_scratch_write", 82, CIN, patches_plain)
stack_reshape = PatchKernel("probe_stack_reshape", 97, CIN, patches_plain)
dma_assemble = PatchKernel("probe_dma_assemble", 111, CIN, patches_plain)
matmul_after_concat = MatmulKernel("probe_matmul_after_concat", 138)
matmul_after_scratch = MatmulKernel("probe_matmul_after_scratch", 159)
mini_kernel = MiniKernel("probe_mini_kernel", 183)
KERNELS = (concat_full_lane, concat_lane_off, scratch_write, stack_reshape,
           dma_assemble, matmul_after_concat, matmul_after_scratch,
           mini_kernel)

"""What the per-layer readers in ``metrics/`` share.  A reader takes the
traced segment and the run's host-side readings and returns a number, or
None where the segment holds nothing to read (then the metric is left out
of the result's line)."""

from __future__ import annotations

from typing import Iterable, Optional

from .counts import peaks, spec_conv, stft
from .trace import Segment

STFT_KERNELS = ("stft_fft_kernel", "stft_dft_kernel")
SPEC_CONV_KERNELS = {"forward": ("spec_conv_fwd_kernel",),
                     "dgrad": ("spec_conv_dgrad_kernel",),
                     "wgrad": ("spec_conv_wgrad_kernel",
                               "sum_partials_kernel")}


def roofline(seg: Segment, kernels: Iterable[str], bounds: Iterable[float]
             ) -> Optional[float]:
    """100 x the launches' least time over the device time of the kernels
    that implement them; None where either is missing."""
    device = sum(d for _, _, d in seg.kernels(*kernels))
    least = sum(bounds)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def stft_roofline(seg: Segment) -> Optional[float]:
    bounds = [peaks.bound_s(*stft.work(b, t, n_fft, hop), "f32")
              for b, t, n_fft, hop in seg.calls.get("stft", [])]
    return roofline(seg, STFT_KERNELS, bounds)


def spec_conv_roofline(seg: Segment) -> Optional[float]:
    bounds, kernels = [], []
    for kind, names in SPEC_CONV_KERNELS.items():
        kernels += names
        bounds += [peaks.bound_s(*spec_conv.work(kind, *shape), "bf16")
                   for shape in seg.calls.get(f"spec_conv.{kind}", [])]
    return roofline(seg, kernels, bounds)


def mfu(seg: Segment) -> Optional[float]:
    """100 x the model FLOP of the traced units, each type at its peak,
    as least time over the window."""
    if not seg.flops or seg.window_s <= 0:
        return None
    least = sum(f / peaks.PEAK_FLOPS[dtype] for unit in seg.flops
                for dtype, f in unit.items())
    return 100.0 * least / seg.window_s


def idle_pct(seg: Segment) -> Optional[float]:
    if seg.window_s <= 0 or not seg.device_ops:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.window_s)


def kernels_per_unit(seg: Segment) -> Optional[float]:
    if seg.units <= 0:
        return None
    launches = [op for op in seg.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]
    return len(launches) / seg.units if launches else None


def host_mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None


"""The reduction from a profiler trace to per-layer metrics, on a trace
written by hand: the window, the union of device intervals, the idle gaps
and what the host did in them, and the readers."""

import pytest

from portbench import readers
from portbench.counts import peaks, spec_conv, stft
from portbench.trace import WINDOW, Segment, segment


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(WINDOW, "user_annotation", 1000.0, 1000.0),
    _x("stft_fft_kernel", "kernel", 1100.0, 100.0),
    _x("spec_conv_fwd_kernel<9, 2>", "kernel", 1150.0, 100.0),  # overlaps
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1400.0, 50.0),
    _x("sum_partials_kernel", "kernel", 1900.0, 200.0),  # cut at the end
    _x("stft_fft_kernel", "kernel", 500.0, 100.0),  # before the window
    _x("aten::item", "cpu_op", 1450.0, 440.0),
    _x("aten::add", "cpu_op", 1460.0, 5.0),
    _x("Optimizer.step#AdamW.step", "cpu_op", 1000.0, 1000.0),
]


def test_segment_clips_to_the_window_and_unions_device_time():
    seg = segment(EVENTS, units=2, calls={})
    assert seg.window_s == pytest.approx(1e-3)
    # [100, 250] + [400, 450] + [900, 1000] us of the window
    assert seg.busy_s() == pytest.approx(300e-6)
    assert readers.idle_pct(seg) == pytest.approx(70.0)
    assert readers.kernels_per_unit(seg) == 1.5  # 3 kernels, 2 units
    gaps = seg.breakdown()["idle_gaps"]
    assert gaps[0][1] == pytest.approx(450e-6)  # [450, 900]
    assert gaps[0][0] == "aten::item"  # the host waited on the card
    top = seg.breakdown()["device_ops"]
    assert top[0][0] == "stft_fft_kernel" or top[0][1] == pytest.approx(
        100e-6)


def test_rooflines_hold_the_recorded_launches_against_their_kernels():
    seg = segment(EVENTS, units=1, calls={
        "stft": [(2, 24000, 1024, 256)],
        "spec_conv.forward": [(2, 257, 101, 9, 2)],
        "spec_conv.wgrad": [(2, 257, 101, 9, 2)]})
    want = peaks.bound_s(*stft.work(2, 24000, 1024, 256), "f32")
    assert readers.stft_roofline(seg) == pytest.approx(
        100 * want / 100e-6)
    bounds = sum(peaks.bound_s(*spec_conv.work(k, 2, 257, 101, 9, 2),
                               "bf16") for k in ("forward", "wgrad"))
    # the forward's 100 us and the wgrad's sum_partials, 100 us in the
    # window
    assert readers.spec_conv_roofline(seg) == pytest.approx(
        100 * bounds / 200e-6)


def test_readers_return_nothing_where_nothing_was_seen():
    seg = Segment(units=1, window_s=1.0, device_ops=[], host_ops=[],
                  calls={})
    assert readers.stft_roofline(seg) is None
    assert readers.spec_conv_roofline(seg) is None
    assert readers.idle_pct(seg) is None
    assert readers.mfu(seg) is None
    assert readers.host_mean_ms([]) is None


def test_mfu_is_least_time_over_the_window():
    seg = Segment(units=2, window_s=2.0, device_ops=[], host_ops=[],
                  calls={}, flops=[{"bf16": 989e12, "f32": 67e12}] * 2)
    assert readers.mfu(seg) == pytest.approx(100.0 * 4.0 / 2.0)

"""The span readers (``portbench/spans.py`` and the six metrics that read
the program's spans) on traces written by hand: each value, the idle
split's sum against ``readers.idle_pct``, None where the spans are absent,
and the launchers that ``spans.owners`` finds through correlation ids."""

import random

import pytest

from portbench import readers, registry, spans
from portbench.trace import WINDOW, Segment, segment

TRAIN_METRICS = ("host_enqueue_ms.train", "idle_in_forward_pct.train",
                 "idle_in_backward_pct.train", "idle_in_optimizer_pct.train")
SYNTH_METRICS = ("upload_ms.synth", "idle_in_upload_pct.synth")


def _x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _read(metric, seg):
    return registry.reader(metric)(seg, {})


# one train step in a window of 1000 us (times from the window's start)
STEP = [
    _x(WINDOW, "user_annotation", 1000.0, 1000.0),
    _x("train.step", "user_annotation", 1050.0, 900.0),
    _x("train.zero_grad", "user_annotation", 1060.0, 40.0),
    _x("train.losses", "user_annotation", 1100.0, 300.0),
    _x("train.forward.speech_predictor", "user_annotation", 1120.0, 100.0),
    _x("train.gan", "user_annotation", 1400.0, 100.0),
    _x("train.backward", "user_annotation", 1520.0, 180.0),
    _x("train.optimizer", "user_annotation", 1720.0, 180.0),
    _x("train.host_read", "user_annotation", 1720.0, 80.0),
    # Kineto's mirror of a span on the device's timeline: neither busy
    # time nor a host span
    _x("train.step", "gpu_user_annotation", 1050.0, 900.0),
    _x("k0", "kernel", 1000.0, 30.0),
    _x("k1", "kernel", 1080.0, 10.0),  # in zero_grad
    _x("k2", "kernel", 1150.0, 150.0),  # in the losses
    _x("k3", "kernel", 1420.0, 60.0),  # in the gan
    _x("k4", "kernel", 1500.0, 150.0),  # across the backward's start
    _x("k5", "kernel", 1800.0, 50.0),  # in the optimizer
    _x("k6", "kernel", 1960.0, 20.0),  # after the step
]


def test_train_readers_split_the_idle_time_by_phase():
    seg = segment(STEP, units=1, calls={})
    assert readers.idle_pct(seg) == pytest.approx(53.0)  # busy 470 of 1000
    assert _read("host_enqueue_ms.train", seg) == pytest.approx(0.9)
    # [100, 500] less k2 and k3
    assert _read("idle_in_forward_pct.train", seg) == pytest.approx(19.0)
    # [520, 700] less k4's [520, 650]
    assert _read("idle_in_backward_pct.train", seg) == pytest.approx(5.0)
    # [60, 100] less k1, and [720, 900] less k5
    assert _read("idle_in_optimizer_pct.train", seg) == pytest.approx(16.0)
    rest = spans.remainders_pct(seg)
    # in the step, outside the phases: [50, 60] + [700, 720] + [900, 950]
    assert rest["in_step"] == pytest.approx(8.0)
    # outside the step: [30, 50] + [950, 960] + [980, 1000]
    assert rest["outside_step"] == pytest.approx(5.0)


@pytest.mark.parametrize("shift", [0.0, 3.5, 41.0])
def test_the_phases_and_remainders_sum_to_the_idle_share(shift):
    """The same trace with the kernels moved: the five parts of the idle
    time add up to ``idle_pct`` wherever the kernels fall."""
    events = [dict(e, ts=e["ts"] + shift) if e["cat"] == "kernel" else e
              for e in STEP]
    seg = segment(events, units=1, calls={})
    parts = [_read(m, seg) for m in TRAIN_METRICS[1:]]
    parts += list(spans.remainders_pct(seg).values())
    assert sum(parts) == pytest.approx(readers.idle_pct(seg))
    assert sum(parts[:3]) <= readers.idle_pct(seg)


def test_host_enqueue_is_the_mean_step_span():
    seg = Segment(units=2, window_s=1.0, device_ops=[],
                  host_ops=[("train.step", 0.0, 0.3),
                            ("train.step", 0.4, 0.5),
                            ("train.losses", 0.1, 0.1)], calls={})
    assert _read("host_enqueue_ms.train", seg) == pytest.approx(400.0)


SYNTH = [
    _x(WINDOW, "user_annotation", 0.0, 1000.0),
    _x("synth.batch", "user_annotation", 0.0, 600.0),
    _x("synth.upload", "user_annotation", 10.0, 30.0),
    _x("synth.upload", "user_annotation", 50.0, 30.0),
    _x("synth.upload", "user_annotation", 300.0, 60.0),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 0.0, 20.0),
    _x("k0", "kernel", 100.0, 400.0),
    _x("k1", "kernel", 700.0, 200.0),
]


def test_synth_readers_read_the_uploads():
    seg = segment(SYNTH, units=2, calls={})
    # 120 us of uploads over 2 batches
    assert _read("upload_ms.synth", seg) == pytest.approx(0.06)
    # [10, 40] less the copy's [10, 20], and [50, 80]; [300, 360] is busy
    assert _read("idle_in_upload_pct.synth", seg) == pytest.approx(5.0)


def test_each_reader_returns_nothing_without_its_spans():
    bare = [e for e in STEP + SYNTH[5:]
            if e["cat"] != "user_annotation" or e["name"] == WINDOW]
    seg = segment(bare, units=1, calls={})
    assert readers.idle_pct(seg) is not None
    for metric in TRAIN_METRICS + SYNTH_METRICS:
        assert _read(metric, seg) is None, metric
    assert spans.remainders_pct(seg) is None
    # a train trace holds no upload, a synth trace no step
    for metric in SYNTH_METRICS:
        assert _read(metric, segment(STEP, 1, {})) is None
    for metric in TRAIN_METRICS:
        assert _read(metric, segment(SYNTH, 1, {})) is None


def test_the_cells_read_the_new_metrics():
    for name, metrics in (("freegan.acoustic_b15", TRAIN_METRICS),
                          ("ringformer.acoustic_b15", TRAIN_METRICS),
                          ("freegan.synth_b32_pipelined", SYNTH_METRICS),
                          ("freegan.synth_b8_closed", SYNTH_METRICS)):
        cell = registry.cell(name)
        found = [m["name"] for m in cell.per_layer]
        assert set(metrics) <= set(found), name
        for m in cell.per_layer:
            if m["name"] in metrics:
                assert m["source"] == "device_trace"


def test_owners_follow_the_correlation_to_the_span_and_ops():
    events = [
        _x("train.losses", "user_annotation", 0.0, 100.0),
        _x("train.loss.slm", "user_annotation", 10.0, 50.0),
        _x("aten::conv1d", "cpu_op", 20.0, 20.0, **{"Sequence number": 5}),
        _x("aten::_convolution", "cpu_op", 22.0, 10.0),
        _x("cudaLaunchKernel", "cuda_runtime", 25.0, 2.0, correlation=7),
        _x("train.backward", "user_annotation", 200.0, 100.0),
        # the backward's op on autograd's thread, the node of the conv1d
        {**_x("autograd::engine::evaluate_function: ConvolutionBackward0",
              "cpu_op", 210.0, 30.0, **{"Sequence number": 5}), "tid": 2},
        # an op of the backward with the node's number: not the forward
        {**_x("aten::convolution_backward", "cpu_op", 215.0, 10.0,
              **{"Sequence number": 5}), "tid": 2},
        {**_x("cuLaunchKernel", "cuda_driver", 220.0, 1.0, correlation=8),
         "tid": 2},
        _x("aten::add", "cpu_op", 400.0, 5.0),
        _x("cudaLaunchKernel", "cuda_runtime", 401.0, 1.0, correlation=9),
        _x("sm80_xmma_gemm_cf32cf32_tn", "kernel", 30.0, 40.0,
           correlation=7),
        _x("dgrad_engine<bf16>", "kernel", 230.0, 25.0, correlation=8),
        _x("dgrad_engine<bf16>", "kernel", 402.0, 5.0, correlation=9),
        _x("dgrad_engine<bf16>", "kernel", 500.0, 1.0, correlation=99),
    ]
    for e in events:
        e.setdefault("tid", 1)
    # autograd's thread first, as a trace may list it
    events.sort(key=lambda e: e["tid"] != 2)
    found = spans.owners(events, ["gemm_cf32cf32", "dgrad_engine"])
    assert found["gemm_cf32cf32"] == {
        "train.loss.slm | aten::conv1d | aten::_convolution":
            pytest.approx(40e-6)}
    assert found["dgrad_engine"] == {
        "train.backward < train.loss.slm | autograd::engine::"
        "evaluate_function: ConvolutionBackward0 | "
        "aten::convolution_backward":
            pytest.approx(25e-6),
        "no span | aten::add | aten::add": pytest.approx(5e-6),
        "no launch traced": pytest.approx(1e-6)}


def _brute(a, b, keep):
    """The length of the points of ``a``'s union that ``keep(in b)``
    holds, by the elementary segments between all endpoints."""
    cuts = sorted({x for iv in a + b for x in iv})
    inside = lambda ivs, x: any(lo < x < hi for lo, hi in ivs)  # noqa: E731
    return sum(hi - lo for lo, hi in zip(cuts, cuts[1:])
               if inside(a, (lo + hi) / 2)
               and keep(inside(b, (lo + hi) / 2)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interval_arithmetic_matches_a_brute_force(seed):
    rng = random.Random(seed)

    def draw():
        return spans.union((x, x + rng.uniform(0.1, 3.0)) for x in
                           (rng.uniform(0, 40) for _ in range(12)))

    a, b = draw(), draw()
    assert spans.length(spans.subtract(a, b)) == pytest.approx(
        _brute(a, b, lambda in_b: not in_b))
    assert spans.length(spans.intersect(a, b)) == pytest.approx(
        _brute(a, b, lambda in_b: in_b))


def test_interval_arithmetic():
    a = [(0.0, 10.0), (20.0, 30.0)]
    b = [(5.0, 25.0)]
    assert spans.subtract(a, b) == [(0.0, 5.0), (25.0, 30.0)]
    assert spans.intersect(a, b) == [(5.0, 10.0), (20.0, 25.0)]
    assert spans.union([(3.0, 4.0), (0.0, 2.0), (1.0, 3.0)]) == [(0.0, 4.0)]
    assert spans.subtract(a, []) == a and spans.intersect(a, []) == []

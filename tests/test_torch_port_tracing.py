"""The port's spans (``utils/profiling.py:span``) in the acoustic train
step and in batch synthesis, at the tiny config on the CPU: off, no span
enters ``record_function``; under ``torch.profiler`` every span named in
``train/stages.py`` and ``export/infer.py`` is in the Chrome trace, nested
as the code nests it; and the step's losses and updated parameters, and
the PCM, are bit-identical with the profiler on and off.
"""

from __future__ import annotations

import json
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stylish_tts_tpu_torch.config import Config
from stylish_tts_tpu_torch.export.infer import Synthesizer
from stylish_tts_tpu_torch.models import build_models
from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                make_train_step)
from stylish_tts_tpu_torch.utils import profiling
from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config
from test_torch_port_helpers import acoustic_batch

PHONEMES = ["ðɪs ɪz ə tˈɛst", "hˈɛloʊ wˈɜːld, haʊ ɑːɹ juː tədˈeɪ?"]

# span -> the span that encloses it (None: outermost), one of each a step
TRAIN_SPANS = {
    "train.step": None,
    "train.zero_grad": "train.step",
    "train.losses": "train.step",
    "train.forward.speech_predictor": "train.losses",
    "train.forward.pe_text_encoder": "train.losses",
    "train.forward.pe_mel_style_encoder": "train.losses",
    "train.forward.pitch_energy_predictor": "train.losses",
    "train.loss.mel": "train.losses",
    "train.loss.spectral": "train.losses",
    "train.loss.slm": "train.losses",
    "train.gan": "train.step",
    "train.gan.generator_view": "train.gan",
    "train.gan.disc_view": "train.gan",
    "train.backward": "train.step",
    "train.optimizer": "train.step",
    "train.host_read": "train.optimizer",
}
# (span, its parent) -> how many one synthesize_batch call emits
SYNTH_SPANS = Counter({
    ("synth.batch", None): 1,
    ("synth.encode", "synth.batch"): 1,
    ("synth.upload", "synth.encode"): 2,  # tokens and lengths
    ("synth.durations", "synth.batch"): 1,
    ("synth.style", "synth.batch"): 1,
    ("synth.upload", "synth.batch"): 1,  # the durations
    ("synth.speech", "synth.batch"): 1,
    ("synth.readback", None): 1,
})


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _refuse(name):
    raise AssertionError(f"span {name!r} entered record_function with no "
                         f"profiler recording")


def _spans(prof, path):
    """(name, name of the innermost span enclosing it on its thread) of
    every span of the profiler's Chrome trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(("train.", "synth."))]
    out = []
    for name, lo, hi, tid in spans:
        around = [(h - l, n) for n, l, h, t in spans
                  if t == tid and l <= lo and hi <= h
                  and (n, l, h) != (name, lo, hi)]
        out.append((name, min(around)[1] if around else None))
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """One acoustic step from the same weights, batch and generator: with
    ``record_function`` refusing every call and no profiler, then under
    the profiler."""
    mc = tiny_model_config()
    mc.slm.layers = 1
    batch, _ = acoustic_batch(mc, seed=5, batch=2, tokens=8, frames=16)

    def step_once():
        state = build_train_state(
            mc, STAGES["acoustic"].models, device="cpu",
            generator=torch.Generator().manual_seed(0))
        ctx = StageContext(model_config=mc, config=Config(), mel_mean=-4.0,
                           mel_std=4.0, step_limit=100,
                           slm=init_slm(mc, torch.Generator().manual_seed(7)))
        step = make_train_step("acoustic", ctx, 1e-4)
        return lambda: step(state, _torch(batch),
                            torch.Generator().manual_seed(3))

    def readings(state, metrics):
        return ({k: v.clone() for k, v in metrics.items()},
                {f"{key}.{n}": p.detach().clone()
                 for key, model in state.models.items()
                 for n, p in model.named_parameters()})

    run = step_once()
    with mock.patch.object(profiling, "record_function", _refuse):
        off = readings(*run())
    run = step_once()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = readings(*run())
    path = tmp_path_factory.mktemp("trace") / "train.json"
    return dict(off=off, on=on, spans=_spans(prof, path))


@pytest.fixture(scope="module")
def synth_runs(tmp_path_factory):
    """``synthesize_batch`` of two utterances from the same weights and
    sampling seed, off (``record_function`` refusing) and profiled."""
    mc = tiny_model_config()
    torch.manual_seed(11)
    models = build_models(mc)

    def synth():
        return Synthesizer(mc, models, device="cpu", sample_seed=4)

    with mock.patch.object(profiling, "record_function", _refuse):
        off = synth().synthesize_batch(PHONEMES)
    s = synth()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = s.synthesize_batch(PHONEMES)
    path = tmp_path_factory.mktemp("trace") / "synth.json"
    return dict(off=off, on=on, spans=_spans(prof, path))


def test_span_off_is_one_shared_no_op():
    with mock.patch.object(profiling, "record_function", _refuse):
        with profiling.span("a") as a:
            assert a is None
        assert profiling.span("a") is profiling.span("b")


def test_span_on_is_a_record_function_range(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("train.outer"):
            with profiling.span("train.inner"):
                torch.ones(4).sum()
    assert sorted(_spans(prof, tmp_path / "t.json")) == [
        ("train.inner", "train.outer"), ("train.outer", None)]


def test_train_step_emits_every_span_nested(train_runs):
    spans = train_runs["spans"]
    assert Counter(name for name, _ in spans) == Counter(list(TRAIN_SPANS))
    assert dict(spans) == TRAIN_SPANS


def test_synthesize_batch_emits_its_spans(synth_runs):
    assert Counter(synth_runs["spans"]) == SYNTH_SPANS


def test_train_step_is_bit_identical_with_the_profiler_on(train_runs):
    (m_off, p_off), (m_on, p_on) = train_runs["off"], train_runs["on"]
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    assert p_off.keys() == p_on.keys()
    for n in p_off:
        assert torch.equal(p_off[n], p_on[n]), n


def test_synthesis_pcm_is_bit_identical_with_the_profiler_on(synth_runs):
    off, on = synth_runs["off"], synth_runs["on"]
    assert len(off) == len(on) == len(PHONEMES)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
        assert a.size > 0

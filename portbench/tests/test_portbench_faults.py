"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU at a tiny size) and the rest
of the run is driven with the fault planted in the program, once for each
fault the cell can have.  One chip a cell: no exchange between chips to
leave out."""

from unittest import mock

import numpy as np
import pytest
import torch

from portbench import card, run as bench_run
from portbench.tests import rehearsal


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(name, cell, out) -> bool:
    with mock.patch.object(card, "describe", lambda chips, peak: {}):
        return bench_run.result_line(cell, out, False)["correct"]


def _run_train(name, broken_step):
    from stylish_tts_tpu_torch.train import stages

    real = stages.make_train_step

    def make(stage, ctx, lr):
        return broken_step(real(stage, ctx, lr))

    with mock.patch.object(stages, "make_train_step", make):
        cell, out = rehearsal.run(name)
    return _correct(name, cell, out), out


def _unchanged(step):
    def broken(state, batch, generator=None, **hooks):
        from stylish_tts_tpu_torch.train import stages
        with mock.patch.object(stages, "apply_updates",
                               lambda opt, lr: None):
            return step(state, batch, generator, **hooks)
    return broken


def _half_batch(step):
    def broken(state, batch, generator=None, **hooks):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(state, half, generator, **hooks)
    return broken


@pytest.mark.parametrize("name", ["freegan.acoustic_b15",
                                  "ringformer.acoustic_b15"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(name, fault):
    correct, out = _run_train(name, fault)
    assert not correct, out["numbers"]


@pytest.mark.parametrize("name", ["freegan.acoustic_b15",
                                  "ringformer.acoustic_b15"])
def test_doubled_spec_conv_wgrad_is_not_correct(name):
    """The MRD's weight gradients from the spec-conv wgrad, doubled (its
    partial sums counted twice), show in the MRD's whole gradient norm,
    which the median leaf over all models does not see."""
    from stylish_tts_tpu_torch.ops import spec_conv

    real = spec_conv.spec_conv_wgrad
    with mock.patch.object(spec_conv, "spec_conv_wgrad",
                           lambda *args: 2 * real(*args)):
        cell, out = rehearsal.run(name)
    assert not _correct(name, cell, out), out["numbers"]
    assert out["numbers"]["norm_gap.mrd"][0] > cell.limits["norm_gap.mrd"]


def test_a_number_the_limits_name_and_the_run_missed_fails():
    got = bench_run.compared({"loss_gap": (1e-5, "first step")},
                             {"loss_gap": 8e-4, "pitch_gap": 2.3e-3})
    assert got["loss_gap"] == {"value": 1e-5, "limit": 8e-4}
    assert got["pitch_gap"]["value"] > got["pitch_gap"]["limit"]


@pytest.mark.parametrize("name", ["freegan.synth_b32_pipelined",
                                  "freegan.synth_b8_closed"])
def test_altered_answer_is_not_correct(name):
    from stylish_tts_tpu_torch.export import infer

    real = infer.Synthesizer.synthesize_batch_async

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        pcm = out.pcm.clone()
        pcm[0, : pcm.shape[1] // 2] = 0  # half of one utterance silenced
        return out._replace(pcm=pcm)

    with mock.patch.object(infer.Synthesizer, "synthesize_batch_async",
                           altered):
        cell, out = rehearsal.run(name)
    assert not _correct(name, cell, out), out["numbers"]


@pytest.mark.parametrize("name", ["freegan.synth_b32_pipelined",
                                  "freegan.synth_b8_closed"])
def test_sound_synthesis_is_correct(name):
    cell, out = rehearsal.run(name)
    assert _correct(name, cell, out), out["numbers"]
    assert np.isfinite(out["e2e"]["synth_audio_s_per_s"])

"""The eval step of the four stages of the port against the JAX package's
``make_eval_step`` at a tiny config (``torch_port_chain.chain_config``):
the same weights, batch and noise (see ``test_torch_port_stages.py``).
Compared: every metric and the synthesized audio, with the F0 head zeroed
and, at looser limits, with a voiced one (``torch_port_chain.zero_f0_head``);
and the eval step leaves the state as it was.  Each JAX eval step is traced
once and run for both heads.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from stylish_tts_tpu.train.stages import make_eval_step as jax_eval_step
from stylish_tts_tpu_torch.train.stages import make_eval_step
from torch_port_chain import (few_threads,  # noqa: F401
                              VOICED_AUDIO, VOICED_MEL_REL, VOICED_SPECTRAL,
                              chain_inputs, jax_noise_fixed, jax_setup,
                              jax_state, model_states, port_batch,
                              port_hooks, port_setup, spectral_distance)

# f32 on both sides, sums in another order
F32_REL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    return chain_inputs()


@pytest.fixture(scope="module",
                params=["acoustic", "textual", "style", "duration"])
def eval_step(request, inputs):
    name, r = request.param, inputs
    state, ctx, jbatch = jax_setup(r["mc_jax"], r["params"], r["stats"],
                                   r["batch"])
    vstate = jax_state(r["mc_jax"], r["voiced_params"], r["stats"])
    with jax_noise_fixed(r["noise"]):
        jitted = jax.jit(jax_eval_step(name, ctx))
        metrics, audio = jitted(state, jbatch, jax.random.PRNGKey(0), None)
        vmetrics, vaudio = jitted(vstate, jbatch, jax.random.PRNGKey(0),
                                  None)
    jax.block_until_ready((metrics, vmetrics))
    pstate, pctx = port_setup(r["mc"], r["params"], r["stats"])
    before = model_states(pstate)
    pmetrics, paudio = make_eval_step(name, pctx)(
        pstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    vpstate, vpctx = port_setup(r["mc"], r["voiced_params"], r["stats"])
    vpmetrics, vpaudio = make_eval_step(name, vpctx)(
        vpstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    return dict(name=name, metrics=metrics, audio=np.asarray(audio),
                pmetrics=pmetrics, paudio=paudio, state=pstate,
                before=before, vmetrics=vmetrics, vaudio=np.asarray(vaudio),
                vpmetrics=vpmetrics, vpaudio=vpaudio.numpy())


def test_eval_step_matches_jax(eval_step):
    s = eval_step
    want = {k: float(v) for k, v in s["metrics"].items()}
    got = {k: float(v) for k, v in s["pmetrics"].items()}
    assert set(got) == set(want), (s["name"], set(got) ^ set(want))
    for key, value in got.items():
        assert abs(value - want[key]) <= F32_REL * abs(want[key]), \
            (s["name"], key, value, want[key])
    # the synthesized audio, within 1e-3 of full scale
    audio = s["paudio"].numpy()
    assert audio.shape == s["audio"].shape and np.all(np.isfinite(audio))
    assert np.abs(audio).max() > 0
    err = float(np.abs(audio - s["audio"]).max())
    assert err <= 1e-3, (s["name"], err)


def test_eval_step_voiced_f0_matches_jax(eval_step):
    """A voiced predicted F0 drives the synthesis of textual, style and
    duration (the whole inference path there): mel, audio and its
    spectrum at the limits of a voiced prior.  Acoustic synthesizes from
    the ground-truth pitch: only its pitch term reads the head, and its
    audio is the zeroed head's."""
    s = eval_step
    want = {k: float(v) for k, v in s["vmetrics"].items()}
    got = {k: float(v) for k, v in s["vpmetrics"].items()}
    assert set(got) == set(want), (s["name"], set(got) ^ set(want))
    for key, value in got.items():
        rel = VOICED_MEL_REL if key == "mel" else F32_REL
        assert abs(value - want[key]) <= rel * abs(want[key]), \
            (s["name"], key, value, want[key])
    audio = s["vpaudio"]
    assert audio.shape == s["vaudio"].shape and np.all(np.isfinite(audio))
    if s["name"] == "acoustic":
        assert np.array_equal(s["vaudio"], s["audio"])
        assert np.abs(audio - s["vaudio"]).max() <= 1e-3
        return
    # the case is voiced: the zeroed head's audio lies far off
    unvoiced = spectral_distance(s["audio"], s["vaudio"])
    assert unvoiced >= 2 * VOICED_SPECTRAL, (s["name"], unvoiced)
    err = float(np.abs(audio - s["vaudio"]).max())
    assert err <= VOICED_AUDIO, (s["name"], err)
    dist = spectral_distance(audio, s["vaudio"])
    assert dist <= VOICED_SPECTRAL, (s["name"], dist)


def test_eval_step_changes_nothing(eval_step):
    s = eval_step
    for key, module in s["state"].models.items():
        assert not module.training, key
        for name, t in module.state_dict().items():
            assert torch.equal(t, s["before"][key][name]), (key, name)
        assert all(p.grad is None for p in module.parameters()), key
        assert not s["state"].optimizers[key].state, key
    assert s["state"].step == 0

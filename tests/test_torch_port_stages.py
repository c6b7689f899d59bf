"""One f32 train step each of the textual, style and duration stages of the
port against the JAX package's jitted ``make_train_step`` at a tiny config
(``torch_port_chain.chain_config``): the same weights (through
``load_flax_params``) and the same numpy-seeded batch.  Compared: the
metrics, each trained module's gradient and update, the mel style
encoder's batch stats, the MRD's EMA, and that every model the stage does
not train is unchanged and holds no gradient.

Randomness is removed on both sides as in ``test_torch_port_train.py``:
dropout off, zero latent noise (``sample=False`` on the port), the
harmonic prior fed the same numpy noise at phase 0.  The F0 head is zeroed
(``torch_port_chain.zero_f0_head``); a second run with a voiced one holds
the metrics at the limits of a voiced prior.  Each JAX step is traced once
for the module and run for both heads.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from stylish_tts_tpu.train.stages import make_train_step as jax_train_step
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.train.stages import STAGES, make_train_step
from test_torch_port_helpers import flatten
from torch_port_chain import (few_threads,  # noqa: F401
                              LR, VOICED_MEL_REL, chain_inputs,
                              jax_noise_fixed, jax_setup, jax_state,
                              model_states, port_batch, port_hooks,
                              port_setup)


@pytest.fixture(scope="module")
def inputs():
    return chain_inputs()


@pytest.fixture(scope="module", params=["textual", "style", "duration"])
def stage_step(request, inputs):
    """The JAX step's and the port's result for one stage."""
    name, r = request.param, inputs
    state, ctx, jbatch = jax_setup(r["mc_jax"], r["params"], r["stats"],
                                   r["batch"])
    vstate = jax_state(r["mc_jax"], r["voiced_params"], r["stats"])
    with jax_noise_fixed(r["noise"]):
        jitted = jax.jit(jax_train_step(name, ctx, LR))
        new_state, metrics = jitted(state, jbatch, jax.random.PRNGKey(0),
                                    None)
        vnew_state, vmetrics = jitted(vstate, jbatch, jax.random.PRNGKey(0),
                                      None)
    jax.block_until_ready((metrics, vmetrics))
    pstate, pctx = port_setup(r["mc"], r["params"], r["stats"])
    before = model_states(pstate)
    ema0 = pstate.disc_ema["mrd"].clone()
    pstate, pmetrics = make_train_step(name, pctx, LR)(
        pstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    vpstate, vpctx = port_setup(r["mc"], r["voiced_params"], r["stats"])
    vpstate, vpmetrics = make_train_step(name, vpctx, LR)(
        vpstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    return dict(name=name, jax_state=new_state, jax_metrics=metrics,
                state=pstate, metrics=pmetrics, before=before, ema0=ema0,
                voiced=dict(jax_state=vnew_state, jax_metrics=vmetrics,
                            state=vpstate, metrics=vpmetrics))


# f32 terms: the same f32 layers, STFTs and mel filterbank summed in
# another order (measured at most 5.7e-7 relative); the MRD runs in bf16
# on both sides (see test_torch_port_train.py's BF16_TERMS; measured
# 3.6e-4 and 7.7e-4)
F32_REL = 1e-5
BF16_TERMS = {"generator": 5e-3, "discriminator": 5e-3}


def test_stage_step_metrics_match_jax(stage_step):
    s = stage_step
    want = {k: float(v) for k, v in s["jax_metrics"].items()}
    got = {k: float(v) for k, v in s["metrics"].items()}
    assert set(got) == set(want), (s["name"], set(got) ^ set(want))
    for key, value in got.items():
        rel = BF16_TERMS.get(key, 2e-4 if key == "loss" else F32_REL)
        assert abs(value - want[key]) <= rel * abs(want[key]), \
            (s["name"], key, value, want[key])


# a voiced predicted F0: textual synthesizes from it, so its spectral
# terms carry the voiced prior's gap (measured: mel 4.2e-4, phase 1.7e-4,
# mag 2.9e-6 relative); style and duration do not synthesize (measured at
# most 1.6e-6)
VOICED_TERMS = {"mel": VOICED_MEL_REL, "phase": VOICED_MEL_REL,
                "mag": VOICED_MEL_REL}


def test_stage_step_voiced_f0_metrics_match_jax(stage_step):
    s, v = stage_step, stage_step["voiced"]
    want = {k: float(x) for k, x in v["jax_metrics"].items()}
    got = {k: float(x) for k, x in v["metrics"].items()}
    assert set(got) == set(want), (s["name"], set(got) ^ set(want))
    for key, value in got.items():
        rel = BF16_TERMS.get(key, VOICED_TERMS.get(
            key, 2e-4 if key == "loss" else F32_REL))
        assert abs(value - want[key]) <= rel * abs(want[key]), \
            (s["name"], key, value, want[key])


# each trained module's gradient, against the JAX step's, as a share of
# the module's largest gradient.  In textual the GAN's generator loss runs
# back through the bf16 MRD into every trained module, so their gradients
# carry the MRD's bf16 error (measured 0.6-1.0% by the max, 0.7-1.1% by
# L2; test_torch_port_train.py measured 4-7% on the acoustic step's speech
# predictor across thread counts), held within 5%; the MRD's own as in
# test_torch_port_train.py (measured 24% and 4.7%).  Style and duration
# are all f32 (measured at most 1.8e-6).
MAX_TOL = {"textual": 0.05, "style": 1e-4, "duration": 1e-4}
L2_TOL = {"textual": 0.05, "style": 1e-4, "duration": 1e-4}
MRD_MAX_TOL, MRD_L2_TOL = 0.4, 0.15


def _module_errors(s, key):
    module = s["state"].models[key]
    stats = ({} if key != "pe_mel_style_encoder"
             else flatten(s["jax_state"].batch_stats[key]))
    mu = flatten(s["jax_state"].opt_states[key].inner_state[0].mu)
    grads = {n: v / 0.15 for n, v in
             load_flax_params(key, {**mu, **stats}, module).items()}
    new = load_flax_params(
        key, {**flatten(s["jax_state"].params[key]), **stats}, module)
    largest = max(float(grads[n].abs().max())
                  for n, _ in module.named_parameters())
    worst = diff2 = ref2 = step_err = 0.0
    for name, p in module.named_parameters():
        diff = p.grad - grads[name]
        worst = max(worst, float(diff.abs().max()))
        diff2 += float(diff.square().sum())
        ref2 += float(grads[name].square().sum())
        step_err = max(step_err, float((p.detach() - new[name]).abs().max()))
    return worst, largest, diff2 ** 0.5, ref2 ** 0.5, step_err


def _check_gradients_and_updates(s, key):
    worst, largest, diff, ref, step_err = _module_errors(s, key)
    max_tol, l2_tol = ((MRD_MAX_TOL, MRD_L2_TOL) if key == "mrd"
                       else (MAX_TOL[s["name"]], L2_TOL[s["name"]]))
    assert worst <= max_tol * largest, (s["name"], key, worst, largest)
    assert diff <= l2_tol * ref, (s["name"], key, diff, ref)
    # AdamW's first step moves each parameter by about lr * sign(grad):
    # a near-zero gradient may flip, so within 2 lr
    assert step_err <= 2 * LR * (1 + 1e-3), (s["name"], key, step_err)


def test_stage_step_gradients_and_updates_match_jax(stage_step):
    s = stage_step
    stage = STAGES[s["name"]]
    for key in stage.train_models + stage.discriminators:
        _check_gradients_and_updates(s, key)
        module = s["state"].models[key]
        assert any(not torch.equal(p.detach(), s["before"][key][n])
                   for n, p in module.named_parameters()), (s["name"], key)


def test_stage_step_voiced_f0_gradients_match_jax(stage_step):
    """The zeroed head's limits hold with a voiced one (measured: textual
    0.11-0.19% by the max and L2, the MRD 24% and 4.8%, style 9.4e-6,
    duration 1.1e-6)."""
    stage = STAGES[stage_step["name"]]
    for key in stage.train_models + stage.discriminators:
        _check_gradients_and_updates(
            dict(stage_step["voiced"], name=stage_step["name"]), key)


def test_stage_step_leaves_other_models_alone(stage_step):
    """Every model the stage does not train, the eval models through which
    gradients pass among them: bit-equal and without a gradient; the
    trained ones hold one."""
    s = stage_step
    stage = STAGES[s["name"]]
    updated = stage.train_models + stage.discriminators
    for key, module in s["state"].models.items():
        if key in updated:
            assert all(p.grad is not None for p in module.parameters()), key
            continue
        for name, t in module.state_dict().items():
            assert torch.equal(t, s["before"][key][name]), \
                (s["name"], key, name)
        assert all(p.grad is None for p in module.parameters()), \
            (s["name"], key)
        assert not s["state"].optimizers[key].state, (s["name"], key)
    assert s["state"].step == 1


def test_stage_step_batch_stats_and_ema_match_jax(stage_step):
    s = stage_step
    module = s["state"].models["pe_mel_style_encoder"]
    stats_j = load_flax_params("pe_mel_style_encoder", {
        **flatten(s["jax_state"].params["pe_mel_style_encoder"]),
        **flatten(s["jax_state"].batch_stats["pe_mel_style_encoder"])},
        module)
    for name, buf in module.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats_j[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        # textual updates the spectral-norm vectors, style only reads them
        updated = s["name"] == "textual"
        assert torch.equal(buf, s["before"]["pe_mel_style_encoder"][name]) \
            is not updated, (s["name"], name)
    ema = float(s["state"].disc_ema["mrd"])
    ema_j = float(s["jax_state"].disc_ema["mrd"])
    if s["name"] == "textual":
        assert ema != float(s["ema0"])
        # 0.05 of the plain LSGAN loss, a bf16 MRD term
        assert abs(ema - ema_j) <= 0.05 * 1e-2 * abs(ema_j)
    else:
        assert ema == float(s["ema0"]) == ema_j



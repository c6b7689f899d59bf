"""The joint stage of the port against the JAX package at a tiny config
(``torch_port_chain.chain_config``): one f32 train step and the eval step
on the same weights, batch and noise (see ``test_torch_port_stages.py``),
then CLI ``train --stage joint`` on a synthetic dataset, started from a
torch reference checkpoint (``--init-torch``) with converted SLM weights.

The train step is compared by its metrics, each trained module's gradient
and update, the MRD's EMA, and that every model outside the stage comes
out bit-equal and without a gradient, the mel style encoder's
spectral-norm ``u``/``sigma`` among them.  The JAX train step and eval
step are each traced once for the module.
"""

from __future__ import annotations

import json
import logging

import jax
import numpy as np
import pytest
import torch

from stylish_tts_tpu.train.stages import make_eval_step as jax_eval_step
from stylish_tts_tpu.train.stages import make_train_step as jax_train_step
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.convert import (export_flax_params,
                                           load_flax_params)
from stylish_tts_tpu_torch.models.torch_convert import CONVERTERS
from stylish_tts_tpu_torch.train.init import (build_training_models,
                                              init_params, init_slm)
from stylish_tts_tpu_torch.train.stages import (STAGES, check_stage,
                                                make_eval_step,
                                                make_train_step)
from stylish_tts_tpu_torch.utils.synthetic import (
    make_synthetic_dataset, tiny_model_config, write_reference_checkpoint)
from stylish_tts_tpu_torch.utils.tensorfile import (read_safetensors,
                                                    write_safetensors)
from test_torch_port_helpers import flatten
from torch_port_chain import (few_threads,  # noqa: F401
                              LR, chain_inputs, jax_noise_fixed, jax_setup,
                              model_states, port_batch, port_hooks,
                              port_setup)

JOINT = STAGES["joint"]


@pytest.fixture(scope="module")
def inputs():
    return chain_inputs()


@pytest.fixture(scope="module")
def joint_step(inputs):
    """The JAX joint step's and the port's result on the same weights."""
    r = inputs
    state, ctx, jbatch = jax_setup(r["mc_jax"], r["params"], r["stats"],
                                   r["batch"])
    with jax_noise_fixed(r["noise"]):
        new_state, metrics = jax.jit(jax_train_step("joint", ctx, LR))(
            state, jbatch, jax.random.PRNGKey(0), {"slm": r["params"]["slm"]})
    jax.block_until_ready(metrics)
    pstate, pctx = port_setup(r["mc"], r["params"], r["stats"],
                              slm=r["params"]["slm"])
    before = model_states(pstate)
    ema0 = pstate.disc_ema["mrd"].clone()
    pstate, pmetrics = make_train_step("joint", pctx, LR)(
        pstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    return dict(jax_state=new_state, jax_metrics=metrics, state=pstate,
                metrics=pmetrics, before=before, ema0=ema0)


def test_joint_stage_is_ported():
    stage = check_stage("joint")
    assert stage.next_stage is None
    assert stage.eval_models == ["pe_mel_style_encoder"]
    assert stage.discriminators == ["mrd"]


# f32 terms: the same f32 layers, STFTs and mel filterbank summed in
# another order (measured at most 2.9e-7 relative); the SLM and the MRD
# run in bf16 on both sides (see test_torch_port_train.py's BF16_TERMS;
# measured slm 1.5e-4, generator 3.6e-4, discriminator 7.8e-4)
F32_REL = 1e-5
BF16_TERMS = {"slm": 5e-3, "generator": 5e-3, "discriminator": 5e-3}


def test_joint_step_metrics_match_jax(joint_step):
    s = joint_step
    want = {k: float(v) for k, v in s["jax_metrics"].items()}
    got = {k: float(v) for k, v in s["metrics"].items()}
    assert set(got) == set(want) == {
        "mel", "slm", "mag", "phase", "style", "pitch", "energy",
        "generator", "discriminator", "loss"}, set(got) ^ set(want)
    for key, value in got.items():
        rel = BF16_TERMS.get(key, 2e-4 if key == "loss" else F32_REL)
        assert abs(value - want[key]) <= rel * abs(want[key]), \
            (key, value, want[key])


# each trained module's gradient against the JAX step's, as a share of the
# module's largest gradient (max) and by relative L2.  The speech
# predictor is fed the predicted pitch and energy, so the GAN and SLM
# terms run back through the bf16 MRD and SLM into every trained module,
# as in the textual stage (test_torch_port_stages.py) and the acoustic
# speech predictor (test_torch_port_train.py): the text-side modules
# within 5% (textual's bound; measured at most 1.9e-6 by the max and 3.3e-6
# by L2, the f32 pitch, energy and style terms dominate theirs), the speech
# predictor and the MRD within the acoustic step's bounds (measured 8.1%
# and 5.4%; 24% and 4.8%).
MAX_TOL = {"pe_text_style_encoder": 0.05, "pitch_energy_predictor": 0.05,
           "pe_text_encoder": 0.05, "speech_predictor": 0.15, "mrd": 0.4}
L2_TOL = {"pe_text_style_encoder": 0.05, "pitch_energy_predictor": 0.05,
          "pe_text_encoder": 0.05, "speech_predictor": 0.1, "mrd": 0.15}


@pytest.mark.parametrize("key", JOINT.train_models + JOINT.discriminators)
def test_joint_step_gradients_and_updates_match_jax(joint_step, key):
    s = joint_step
    module = s["state"].models[key]
    mu = flatten(s["jax_state"].opt_states[key].inner_state[0].mu)
    # the first AdamW moment after one step is (1 - b1) * grad
    grads = {n: v / 0.15 for n, v in
             load_flax_params(key, mu, module).items()}
    new = load_flax_params(key, flatten(s["jax_state"].params[key]), module)
    largest = max(float(grads[n].abs().max())
                  for n, _ in module.named_parameters())
    worst = diff2 = ref2 = 0.0
    for name, p in module.named_parameters():
        assert p.grad is not None, (key, name)
        diff = p.grad - grads[name]
        worst = max(worst, float(diff.abs().max()))
        diff2 += float(diff.square().sum())
        ref2 += float(grads[name].square().sum())
        # AdamW's first step moves each parameter by about lr * sign(grad):
        # a near-zero gradient may flip, so within 2 lr
        step_err = float((p.detach() - new[name]).abs().max())
        assert step_err <= 2 * LR * (1 + 1e-3), (key, name, step_err)
    assert worst <= MAX_TOL[key] * largest, (key, worst, largest)
    assert diff2 ** 0.5 <= L2_TOL[key] * ref2 ** 0.5, (key, diff2, ref2)
    assert any(not torch.equal(p.detach(), s["before"][key][n])
               for n, p in module.named_parameters()), key


def test_joint_step_leaves_the_other_models_alone(joint_step):
    """The mel style encoder (its spectral-norm u and sigma too) and every
    model outside the stage: bit-equal, without a gradient or optimizer
    state; so is the JAX step's mel style encoder."""
    s = joint_step
    updated = JOINT.train_models + JOINT.discriminators
    for key, module in s["state"].models.items():
        if key in updated:
            continue
        for name, t in module.state_dict().items():
            assert torch.equal(t, s["before"][key][name]), (key, name)
        assert all(p.grad is None for p in module.parameters()), key
        assert not s["state"].optimizers[key].state, key
    module = s["state"].models["pe_mel_style_encoder"]
    want = load_flax_params("pe_mel_style_encoder", {
        **flatten(s["jax_state"].params["pe_mel_style_encoder"]),
        **flatten(s["jax_state"].batch_stats["pe_mel_style_encoder"])},
        module)
    for name, t in module.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert s["state"].step == 1


def test_joint_step_updates_the_ema_like_jax(joint_step):
    s = joint_step
    ema, ema_j = float(s["state"].disc_ema["mrd"]), float(
        s["jax_state"].disc_ema["mrd"])
    assert ema != float(s["ema0"])
    # 0.05 of the plain LSGAN loss, a bf16 MRD term (measured 5.0e-5)
    assert abs(ema - ema_j) <= 0.05 * 1e-2 * abs(ema_j)


def test_joint_eval_step_matches_jax(inputs):
    """The joint validation: the text style vector drives the predicted
    pitch and energy, which drive the synthesis; a ``style`` metric.  At
    the tolerances of ``test_torch_port_stages_eval.py``, and the state
    unchanged."""
    r = inputs
    state, ctx, jbatch = jax_setup(r["mc_jax"], r["params"], r["stats"],
                                   r["batch"])
    with jax_noise_fixed(r["noise"]):
        metrics, audio = jax.jit(jax_eval_step("joint", ctx))(
            state, jbatch, jax.random.PRNGKey(0), None)
    pstate, pctx = port_setup(r["mc"], r["params"], r["stats"])
    before = model_states(pstate)
    pmetrics, paudio = make_eval_step("joint", pctx)(
        pstate, port_batch(r["batch"]), **port_hooks(r["noise"]))
    want = {k: float(v) for k, v in metrics.items()}
    got = {k: float(v) for k, v in pmetrics.items()}
    assert set(got) == set(want) == {"mel", "pitch", "energy", "style",
                                     "loss"}
    for key, value in got.items():
        assert abs(value - want[key]) <= F32_REL * abs(want[key]), \
            (key, value, want[key])
    paudio, audio = paudio.numpy(), np.asarray(audio)
    assert paudio.shape == audio.shape and np.all(np.isfinite(paudio))
    assert np.abs(paudio).max() > 0
    assert float(np.abs(paudio - audio).max()) <= 1e-3
    for key, module in pstate.models.items():
        for name, t in module.state_dict().items():
            assert torch.equal(t, before[key][name]), (key, name)


def test_cli_train_joint_writes_its_checkpoint(tmp_path, caplog):
    """CLI ``train --stage joint --max-steps 2 --init-torch`` on the CPU
    with ``slm.weights_path`` set: the stage runs alone (no next stage)
    from the reference checkpoint's weights and the SLM file, validates,
    and writes its final checkpoint and manifest; the models the stage
    does not train end as the reference checkpoint's, bit for bit."""
    make_synthetic_dataset(tmp_path / "data", n_segments=6)
    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.mel_style_encoder.max_channels = 64
    generator = torch.Generator().manual_seed(5)
    reference = {k: init_params(m, generator)
                 for k, m in build_training_models(mc).items()
                 if k in CONVERTERS}
    write_reference_checkpoint(tmp_path / "reference", reference,
                               safetensors=("mrd", "speech_predictor"))
    write_safetensors(tmp_path / "slm.safetensors", export_flax_params(
        "slm", init_slm(mc, torch.Generator().manual_seed(6))))
    mc.slm.weights_path = str(tmp_path / "slm.safetensors")
    (tmp_path / "model.json").write_text(dump_json(mc))
    cfg = Config()
    cfg.dataset.path = str(tmp_path / "data")
    cfg.training_plan.joint.probe_batch_max = 2
    cfg.training.log_interval = 1
    cfg.training.val_interval = 2
    (tmp_path / "config.json").write_text(dump_json(cfg))
    with caplog.at_level(logging.INFO):
        main(["train", "--config", str(tmp_path / "config.json"),
              "--model-config", str(tmp_path / "model.json"), "--out",
              str(tmp_path / "out"), "--stage", "joint", "--max-steps", "2",
              "--init-torch", str(tmp_path / "reference"),
              "--device", "cpu", "--workers", "2"])
    assert "init-torch: imported speech_predictor" in caplog.text
    assert "skipping text_aligner" in caplog.text  # not in the chain
    assert "slm.weights_path is unset" not in caplog.text
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == ["joint"]
    final = out / "joint" / "checkpoint_final"
    manifest = json.loads((final / "meta.json").read_text())["manifest"]
    assert manifest["stage"] == "joint"
    assert manifest["current_total_step"] == manifest["current_step"] == 2
    assert (final / "models" / "speech_predictor.safetensors").is_file()
    stats = json.loads((out / "joint" / "train_stats.json").read_text())
    assert stats["steps"] == 2 and [v["step"] for v in
                                    stats["validations"]] == [2]
    assert set(stats["logs"][0]["metrics"]) == {
        "mel", "slm", "mag", "phase", "style", "pitch", "energy",
        "generator", "discriminator"}
    assert all(np.isfinite(v) for e in stats["logs"]
               for v in e["metrics"].values())
    assert "Git commit hash:" in (out / "git_state.txt").read_text()
    for key in ("duration_predictor", "pe_mel_style_encoder"):
        saved = read_safetensors(final / "models" / f"{key}.safetensors")
        want = export_flax_params(key, reference[key])
        assert set(saved) == set(want), key
        for name, value in want.items():
            assert np.array_equal(saved[name], value), (key, name)

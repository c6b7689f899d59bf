"""The ``hubert_acoustic`` stage of the port against the JAX package at a
tiny config (``torch_port_experimental.experimental_config``): its three
models alone (f32 forward within 1e-4 of the largest output), then one f32
train step and the eval step on the same weights, batch, frozen nets and
noise.  The JAX train step and eval step are each traced once.

Randomness is removed on both sides: dropout off, zero latent noise, the
harmonic prior's noise shared at phase 0 (``torch_port_chain.
jax_noise_fixed``), on a batch whose F0 and prior are well-posed
(``acoustic_batch``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.train.stages import make_eval_step as jax_eval_step
from stylish_tts_tpu.train.stages import make_train_step as jax_train_step
from stylish_tts_tpu_torch.train.stages import (STAGES, check_stage,
                                                make_eval_step,
                                                make_train_step)
from test_torch_port_helpers import (acoustic_batch, assert_close,
                                     speech_level, train_params)
from torch_port_chain import jax_noise_fixed
from torch_port_experimental import (few_threads,  # noqa: F401
                                     LR, check_update, experimental_config,
                                     jax_batch, jax_models, jax_setup,
                                     jax_small_nets, model_params,
                                     model_states, port_batch, port_models,
                                     port_module, port_setup, small_nets)

STAGE = STAGES["hubert_acoustic"]
KEYS = ["hubert_speech_predictor", "hubert_pitch_energy_predictor"]
FRAMES = 16


@pytest.fixture(scope="module")
def inputs():
    mc_jax, mc = experimental_config()
    models = jax_models(mc_jax)
    params, _ = model_params(mc_jax, models, KEYS + ["hubert_encoder"],
                             seed=40)
    speech_level({"speech_predictor": params["hubert_speech_predictor"]})
    chain, _ = train_params(mc_jax, seed=7)
    params["mrd"] = chain["mrd"]
    hub_p, spk_p, ssl = small_nets(mc_jax)
    batch, noise = acoustic_batch(mc_jax, seed=3, tokens=8, frames=FRAMES)
    return dict(mc_jax=mc_jax, mc=mc, models=models, params=params,
                slm=chain["slm"], hub_p=hub_p, spk_p=spk_p, ssl=ssl,
                batch=batch, noise=noise)


def _hooks(noise):
    return dict(sample=False, pcph_noise=torch.from_numpy(noise),
                pcph_phase=torch.zeros(1, 1))


def _features(r):
    """Unit-normal HuBERT features [2, FRAMES, hubert_dim] and speaker
    vectors [2, speaker_dim], the modules' inputs."""
    rng = np.random.default_rng(11)
    mc = r["mc"]
    return (rng.standard_normal((2, FRAMES, mc.hubert.hidden_dim))
            .astype(np.float32),
            rng.standard_normal((2, mc.speaker_embedder.hidden_dim))
            .astype(np.float32))


def test_hubert_encoder_matches_jax(inputs):
    r = inputs
    phones, _ = _features(r)
    lengths = np.array([FRAMES, FRAMES - 5], np.int32)
    p = r["params"]["hubert_encoder"]
    want = jax.jit(r["models"]["hubert_encoder"].apply)(
        {"params": p}, jnp.asarray(phones), jnp.asarray(lengths))
    port = port_module(port_models(r["mc"], ["hubert_encoder"])
                       ["hubert_encoder"], p)
    with torch.no_grad():
        got = port(torch.from_numpy(phones), torch.from_numpy(lengths))
    assert got.shape == (2, FRAMES, r["mc"].inter_dim)
    assert_close(got, np.asarray(want), what="HubertEncoder")


def test_hubert_pitch_energy_predictor_matches_jax(inputs):
    r = inputs
    phones, spk = _features(r)
    lengths = np.array([FRAMES, FRAMES], np.int32)
    key = "hubert_pitch_energy_predictor"
    want = jax.jit(r["models"][key].apply)(
        {"params": r["params"][key]}, jnp.asarray(phones),
        jnp.asarray(lengths), jnp.asarray(spk))
    port = port_module(port_models(r["mc"], [key])[key], r["params"][key])
    with torch.no_grad():
        got = port(torch.from_numpy(phones), torch.from_numpy(lengths),
                   torch.from_numpy(spk))
    for g, w, what in zip(got, want, ("f0", "energy")):
        assert g.shape == (2, FRAMES)
        assert_close(g, np.asarray(w), what=what)


@pytest.mark.parametrize("posterior", [False, True],
                         ids=["synthesis", "training"])
def test_hubert_speech_predictor_matches_jax(inputs, posterior):
    """Synthesis from the prior and, with ``audio_gt``, the training path
    through the posterior: audio, log-amplitude, phase and (training) the
    four flow-stat triples."""
    r = inputs
    phones, spk = _features(r)
    b = r["batch"]
    lengths = np.array([FRAMES, FRAMES], np.int32)
    energy = np.random.default_rng(4).random((2, FRAMES)).astype(np.float32)
    args = [phones, lengths, spk, b["pitch"], energy]
    if posterior:
        args.append(b["audio_gt"])
    key = "hubert_speech_predictor"
    module = r["models"][key]
    with jax_noise_fixed(r["noise"]):
        want = jax.jit(functools.partial(module.apply, sample=False))(
            {"params": r["params"][key]}, *map(jnp.asarray, args),
            rngs={"sample": jax.random.PRNGKey(0)})
    port = port_module(port_models(r["mc"], [key])[key], r["params"][key])
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args), **_hooks(r["noise"]))
    assert got.audio.shape == (2, FRAMES * 300)
    for name in ("audio", "magnitude", "phase"):
        assert_close(getattr(got, name), np.asarray(getattr(want, name)),
                     what=name)
    if posterior:
        for name in ("text_stats", "text2mel_stats", "mel_stats",
                     "mel2text_stats"):
            for g, w in zip(getattr(got, name), getattr(want, name)):
                assert_close(g, np.asarray(w), what=name)


@pytest.fixture(scope="module")
def hubert_step(inputs):
    r = inputs
    params = {k: r["params"][k] for k in KEYS + ["mrd"]}
    state, ctx = jax_setup(r["mc_jax"], r["models"], params, {})
    with jax_small_nets(), jax_noise_fixed(r["noise"]):
        new_state, metrics = jax.jit(jax_train_step(
            "hubert_acoustic", ctx, LR))(
            state, jax_batch(r["batch"]), jax.random.PRNGKey(0),
            {"slm": r["slm"], "ssl": (r["hub_p"], r["spk_p"])})
        jax.block_until_ready(metrics)
    pstate, pctx = port_setup(r["mc"], params, {}, r["ssl"], slm=r["slm"])
    before = model_states(pstate)
    ema0 = pstate.disc_ema["mrd"].clone()
    pstate, pmetrics = make_train_step("hubert_acoustic", pctx, LR)(
        pstate, port_batch(r["batch"]), **_hooks(r["noise"]))
    return dict(jax_state=new_state, jax_metrics=metrics, state=pstate,
                metrics=pmetrics, before=before, ema0=ema0)


def test_hubert_acoustic_stage_is_ported():
    stage = check_stage("hubert_acoustic")
    assert stage.next_stage is None and stage.discriminators == ["mrd"]
    assert stage.train_models == KEYS


# f32 terms within 1e-3 relative (the same f32 layers, STFTs and mel
# filterbank summed in another order); the SLM and the MRD run in bf16 on
# both sides, as in the acoustic step (test_torch_port_train.py)
F32_REL = 1e-3
BF16_TERMS = {"slm": 5e-3, "generator": 5e-3, "discriminator": 5e-3}


def test_hubert_acoustic_metrics_match_jax(hubert_step):
    s = hubert_step
    want = {k: float(v) for k, v in s["jax_metrics"].items()}
    got = {k: float(v) for k, v in s["metrics"].items()}
    assert set(got) == set(want) == {
        "mel", "slm", "mag", "phase", "pitch", "energy", "kl_text",
        "kl_audio", "generator", "discriminator", "loss"}, \
        set(got) ^ set(want)
    for key, value in got.items():
        rel = BF16_TERMS.get(key, F32_REL)
        assert abs(value - want[key]) <= rel * abs(want[key]) + 1e-6, \
            (key, value, want[key])


# the gradients at the limits of the joint step (test_torch_port_joint.py):
# the pitch/energy predictor gets its gradient from f32 terms alone, the
# speech predictor and the MRD also through the bf16 MRD and SLM
MAX_TOL = {"hubert_pitch_energy_predictor": 0.05,
           "hubert_speech_predictor": 0.15, "mrd": 0.4}
L2_TOL = {"hubert_pitch_energy_predictor": 0.05,
          "hubert_speech_predictor": 0.1, "mrd": 0.15}


@pytest.mark.parametrize("key", STAGE.train_models + STAGE.discriminators)
def test_hubert_acoustic_update_matches_jax(hubert_step, key):
    s = hubert_step
    check_update(s["jax_state"], s["state"], s["before"], key, MAX_TOL[key],
                 L2_TOL[key])


def test_hubert_acoustic_ema_and_step(hubert_step):
    s = hubert_step
    ema, ema_j = float(s["state"].disc_ema["mrd"]), float(
        s["jax_state"].disc_ema["mrd"])
    assert ema != float(s["ema0"])
    # 0.05 of the plain LSGAN loss, a bf16 MRD term
    assert abs(ema - ema_j) <= 0.05 * 1e-2 * abs(ema_j)
    assert s["state"].step == 1


def test_hubert_acoustic_eval_matches_jax(inputs):
    """The validation: synthesis from the frozen features and the
    ground-truth pitch, the pitch/energy predictor's losses; the state
    unchanged."""
    r = inputs
    params = {k: r["params"][k] for k in KEYS + ["mrd"]}
    state, ctx = jax_setup(r["mc_jax"], r["models"], params, {})
    with jax_small_nets(), jax_noise_fixed(r["noise"]):
        metrics, audio = jax.jit(jax_eval_step("hubert_acoustic", ctx))(
            state, jax_batch(r["batch"]), jax.random.PRNGKey(0),
            {"ssl": (r["hub_p"], r["spk_p"])})
    pstate, pctx = port_setup(r["mc"], params, {}, r["ssl"])
    before = model_states(pstate)
    pmetrics, paudio = make_eval_step("hubert_acoustic", pctx)(
        pstate, port_batch(r["batch"]), **_hooks(r["noise"]))
    want = {k: float(v) for k, v in metrics.items()}
    got = {k: float(v) for k, v in pmetrics.items()}
    assert set(got) == set(want) == {"mel", "pitch", "energy", "loss"}
    for key, value in got.items():
        assert abs(value - want[key]) <= F32_REL * abs(want[key]), \
            (key, value, want[key])
    assert_close(paudio, np.asarray(audio), what="eval audio")
    assert float(paudio.abs().max()) > 0
    for key, module in pstate.models.items():
        for name, t in module.state_dict().items():
            assert torch.equal(t, before[key][name]), (key, name)

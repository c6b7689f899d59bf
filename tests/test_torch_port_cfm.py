"""The CFM stages of the port against the JAX package at a tiny config
(``torch_port_experimental.experimental_config``): the XUT pieces, the
CFM sampler, the mel decoder (eval and the TREAD train route) and the
pitch predictor alone (f32 forward within 1e-4 of the largest output),
then ``cfm_hubert_pitch`` and ``cfm_hubert_mel``: one f32 train step each
(losses within 1e-3 relative, each trained model's update) and their eval
steps, ``cfm_hubert_mel`` with Griffin-Lim in the model's mel space and
with Vocos in Vocos's.  Each JAX step is traced once.

The draws no two frameworks share are handed to the port and patched
into ``jax.random`` by shape (``torch_port_experimental.jax_draws``): CFM's
t, z and condition-drop uniforms, the TREAD route's uniforms, the sine
source's noise, the solve's initial noise and Griffin-Lim's phase.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.models import xut as J
from stylish_tts_tpu.train.stages import make_eval_step as jax_eval_step
from stylish_tts_tpu.train.stages import make_train_step as jax_train_step
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models import xut as P
from stylish_tts_tpu_torch.models.cfm import CfmSampler, sinusoidal_pos_emb
from stylish_tts_tpu_torch.train.optim import WEIGHT_DECAY
from stylish_tts_tpu_torch.train.stages import (make_eval_step,
                                                make_train_step)
from test_torch_port_helpers import (acoustic_batch, assert_close, flatten,
                                     param_shapes)
from torch_port_experimental import (few_threads,  # noqa: F401
                                     check_update, experimental_config,
                                     jax_batch, jax_draws, jax_models,
                                     jax_setup, jax_small_nets,
                                     model_params, model_states, port_batch,
                                     port_models, port_module, port_setup,
                                     seeded, small_nets, small_vocos)

KEYS = ["cfm_pitch_predictor", "cfm_mel_decoder", "hubert_encoder"]
B, FRAMES = 2, 16
# the mel decoder's step at a large LR: at 1e-4 AdamW's decay factor
# 1 - lr * 1e-4 rounds to 1 in f32, and the hubert encoder, which no loss
# reaches, would not move at all
LR_PITCH, LR_MEL = 1e-4, 1e-2


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------- #
# models/xut.py, models/cfm.py


def _xut_case(jmod, pmod, args, kwargs=None, seed=0):
    kwargs = kwargs or {}
    jin = [None if a is None else jnp.asarray(a) for a in args]
    params = seeded(param_shapes(jmod, *jin, **kwargs), seed)
    want = jax.jit(functools.partial(jmod.apply, **kwargs))(
        {"params": params}, *jin)
    port_module(pmod, params)
    tkw = {k: tuple(torch.from_numpy(np.asarray(c)) for c in v)
           if isinstance(v, tuple) else v for k, v in kwargs.items()}
    with torch.no_grad():
        got = pmod(*[None if a is None else torch.from_numpy(a)
                     for a in args], **tkw)
    return got, want


def _shared(dim, seed):
    return tuple(tuple(_rand(B, 1, dim, seed=seed + 3 * i + j)
                       for j in range(3)) for i in range(3))


@pytest.mark.parametrize("case", ["plain", "cross", "shared_cross"])
def test_xut_block_matches_jax(case):
    """One block: its own AdaLN heads (seeded, not zero) from t_emb, with
    a cross-attention to a context, and with modulations shared from
    outside (no AdaLN heads of its own)."""
    dim, heads, t = 32, 4, 10
    cross, shared = case != "plain", case == "shared_cross"
    x, t_emb = _rand(B, t, dim, seed=1), _rand(B, dim, seed=2)
    pos = np.linspace(-1, 1, t, dtype=np.float32)[None, :, None].repeat(B, 0)
    skip = _rand(B, t, dim, seed=3) if cross else None
    kwargs = {"skip": skip, "skip_pos": pos if cross else None}
    if shared:
        kwargs["shared_adaln"] = _shared(dim, 10)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kwargs.items() if k != "shared_adaln"}
    if shared:
        jkw["shared_adaln"] = tuple(tuple(map(jnp.asarray, s))
                                    for s in kwargs["shared_adaln"])
    jmod = J.XUTBlock(dim, heads, dim * 4, cross=cross)
    params = seeded(param_shapes(jmod, jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(t_emb), **jkw), 4)
    assert ("xattn" in params) == cross
    assert ("adaln" in params["attn_pre_norm"]) == (not shared)
    want = jax.jit(functools.partial(jmod.apply, **jkw))(
        {"params": params}, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(t_emb))
    pmod = port_module(P.XUTBlock(dim, heads, dim * 4, cross=cross,
                                  shared=shared), params)
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kwargs.items() if k != "shared_adaln"}
    if shared:
        pkw["shared_adaln"] = tuple(tuple(map(torch.from_numpy, s))
                                    for s in kwargs["shared_adaln"])
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(pos),
                   torch.from_numpy(t_emb), **pkw)
    assert_close(got, np.asarray(want), what=case)


def test_xut_backbone_time_embedding_and_modulation_match_jax():
    """The U backbone (2 levels, shared modulations), the timestep
    embedding and the shared AdaLN modulation head."""
    dim, heads, t = 32, 4, 12
    x, t_emb = _rand(B, t, dim, seed=5), _rand(B, dim, seed=6)
    pos = np.linspace(-1, 1, t, dtype=np.float32)[None, :, None].repeat(B, 0)
    shared = _shared(dim, 20)
    jmod = J.XUTBackbone(dim, heads, dim * 2, depth=2)
    jshared = tuple(tuple(map(jnp.asarray, s)) for s in shared)
    params = seeded(param_shapes(jmod, jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(t_emb), shared_adaln=jshared),
                    7)
    want = jax.jit(functools.partial(jmod.apply, shared_adaln=jshared))(
        {"params": params}, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(t_emb))
    pmod = port_module(P.XUTBackbone(dim, heads, dim * 2, depth=2,
                                     shared=True), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(pos),
                   torch.from_numpy(t_emb),
                   shared_adaln=tuple(tuple(map(torch.from_numpy, s))
                                      for s in shared))
    assert_close(got, np.asarray(want), what="XUTBackbone")
    steps = np.array([0.0, 0.37], np.float32)
    got, want = _xut_case(J.TimestepEmbedding(dim),
                          P.TimestepEmbedding(dim), [steps], seed=8)
    assert_close(got, np.asarray(want), what="TimestepEmbedding")
    got, want = _xut_case(J.AdaLNModulation(dim), P.AdaLNModulation(dim),
                          [t_emb], seed=9)
    for g, w in zip(got, want):
        assert g.shape == (B, 1, dim)
        assert_close(g, np.asarray(w), what="AdaLNModulation")
    from stylish_tts_tpu.models.cfm import sinusoidal_pos_emb as jax_emb

    assert_close(sinusoidal_pos_emb(torch.from_numpy(steps), 16),
                 np.asarray(jax_emb(jnp.asarray(steps), 16)),
                 what="sinusoidal_pos_emb")


def test_cfm_sampler_matches_jax():
    """``sample``'s Euler loop and ``compute_pred_target``'s guided pair
    on a closed-form estimator, with t, z and the drop uniforms shared
    (one condition dropped for one item)."""
    from stylish_tts_tpu.models.cfm import CfmSampler as JaxSampler

    x1, cond, spk = (_rand(B, 6, 4, seed=1), _rand(B, 6, 4, seed=2),
                     _rand(B, 3, seed=3))
    t = np.array([0.3, 0.8], np.float32).reshape(B, 1, 1)
    z = _rand(B, 6, 4, seed=4)
    keep = np.array([0.9, 0.1], np.float32).reshape(B, 1, 1)

    def estimator(np_):
        def f(x, t, cond, spk):
            return x * np_.tanh(cond) + t[:, None, None] * spk.sum(-1)[
                :, None, None] - 0.5 * x
        return f

    jsampler = JaxSampler(estimator(jnp), cond_drop_prob=0.5,
                          non_drop_conds=["spk"])
    with jax_draws(uniform={(B, 1, 1): [t, keep]}, normal={(B, 6, 4): z}):
        jpred, jtarget = jsampler.compute_pred_target(
            jax.random.PRNGKey(0), jnp.asarray(x1), cond=jnp.asarray(cond),
            spk=jnp.asarray(spk))
    jsample = jsampler.sample(jnp.asarray(z), 5, cond=jnp.asarray(cond),
                              spk=jnp.asarray(spk))
    sampler = CfmSampler(estimator(torch), cond_drop_prob=0.5,
                         non_drop_conds=["spk"])
    tc, ts = torch.from_numpy(cond), torch.from_numpy(spk)
    pred, target = sampler.compute_pred_target(
        torch.from_numpy(x1), draws={"t": torch.from_numpy(t),
                                     "z": torch.from_numpy(z),
                                     "keep": {"cond": torch.from_numpy(keep)}},
        cond=tc, spk=ts)
    assert_close(pred, np.asarray(jpred), what="pred")
    assert_close(target, np.asarray(jtarget), what="target")
    assert_close(sampler.sample(torch.from_numpy(z), 5, cond=tc, spk=ts),
                 np.asarray(jsample), what="sample")
    draws = sampler.draw(torch.from_numpy(x1), {"cond": tc, "spk": ts},
                         torch.Generator().manual_seed(0))
    assert draws["t"].shape == (B, 1, 1) and set(draws["keep"]) == {"cond"}


def test_f0_zscore_matches_jax():
    """The CFM pitch target and its inverse: log2 z-score, unvoiced at 0,
    the inverse clamped to 50-1200 Hz."""
    from stylish_tts_tpu.train import stages as jstages
    from stylish_tts_tpu_torch.train.stages import (denorm_f0_zscore,
                                                    norm_f0_zscore)

    f0 = np.array([[0.0, 40.0, 110.0, 180.0, 0.0, 900.0, 2000.0]],
                  np.float32)
    unvoiced = f0 == 0
    want = np.asarray(jstages.norm_f0_zscore(jnp.asarray(f0),
                                             jnp.asarray(unvoiced), 7.3, 0.4))
    got = norm_f0_zscore(torch.from_numpy(f0), torch.from_numpy(unvoiced),
                         7.3, 0.4)
    assert_close(got, want, what="norm_f0_zscore")
    back = denorm_f0_zscore(got, torch.from_numpy(unvoiced), 7.3, 0.4)
    assert_close(back, np.asarray(jstages.denorm_f0_zscore(
        jnp.asarray(want), jnp.asarray(unvoiced), 7.3, 0.4)),
        what="denorm_f0_zscore")
    assert float(back[0, 1]) == 50.0 and float(back[0, 6]) == 1200.0


# --------------------------------------------------------------------------- #
# the two CFM models


@pytest.fixture(scope="module")
def inputs():
    mc_jax, mc = experimental_config()
    models = jax_models(mc_jax)
    params, stats = model_params(mc_jax, models, KEYS, seed=60)
    hub_p, spk_p, ssl = small_nets(mc_jax)
    batch, _ = acoustic_batch(mc_jax, seed=5, tokens=8, frames=FRAMES)
    return dict(mc_jax=mc_jax, mc=mc, models=models, params=params,
                stats=stats, hub_p=hub_p, spk_p=spk_p, ssl=ssl, batch=batch)


def _decoder_inputs(mc, frames, feat):
    return [_rand(B, frames, feat, seed=11), np.array([0.2, 0.7], np.float32),
            _rand(B, frames, mc.hubert.hidden_dim, seed=12),
            np.abs(_rand(B, frames, seed=13)) * 200.0,
            _rand(B, frames, seed=14),
            _rand(B, mc.speaker_embedder.hidden_dim, seed=15)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "tread"])
def test_cfm_mel_decoder_matches_jax(inputs, train):
    """Eval, and the train path's TREAD route (half the frames through the
    U backbone) on the same route uniforms and sine-source noise; half the
    F0 frames unvoiced."""
    r = inputs
    key = "cfm_mel_decoder"
    args = _decoder_inputs(r["mc"], FRAMES, r["mc"].n_mels)
    args[3][:, ::2] = 0.0
    noise, route = _rand(B, FRAMES, seed=16), np.random.default_rng(
        17).random((B, FRAMES)).astype(np.float32)
    module = r["models"][key]
    with jax_draws(uniform={(B, FRAMES): route},
                   normal={(B, FRAMES): noise}):
        want = jax.jit(functools.partial(module.apply, train=train))(
            {"params": r["params"][key]}, *map(jnp.asarray, args),
            rngs={"sample": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)})
    port = port_module(port_models(r["mc"], [key])[key], r["params"][key])
    port.train(train)
    draws = {"noise": torch.from_numpy(noise)}
    if train:
        draws["route"] = torch.from_numpy(route)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args), draws=draws)
    assert got.shape == (B, FRAMES, r["mc"].n_mels)
    assert_close(got, np.asarray(want), what=f"CfmMelDecoder {train}")


def test_cfm_pitch_predictor_matches_jax(inputs):
    r = inputs
    key = "cfm_pitch_predictor"
    asr, mel = (_rand(B, FRAMES, r["mc"].hubert.hidden_dim, seed=21),
                _rand(B, FRAMES, r["mc"].n_mels, seed=22))
    want = jax.jit(r["models"][key].apply)(
        {"params": r["params"][key], "batch_stats": r["stats"][key]},
        jnp.asarray(asr), jnp.asarray(mel))
    port = port_models(r["mc"], [key])[key]
    port.load_state_dict(load_flax_params(key, {
        **flatten(r["params"][key]), **flatten(r["stats"][key])}, port))
    with torch.no_grad():
        got = port(torch.from_numpy(asr), torch.from_numpy(mel))
    assert got.shape == (B, FRAMES)
    assert_close(got, np.asarray(want), what="CfmPitchPredictor")


# --------------------------------------------------------------------------- #
# the stages


def _frozen(r):
    return {"ssl": (r["hub_p"], r["spk_p"])}


def _mel_frames(r):
    return r["batch"]["audio_gt"].shape[1] // r["mc"].hop_length


def _train_draws(r):
    """The train step's draws, numpy: t, z, the drop uniforms of the
    three droppable conditions, the sine noise and the route."""
    frames, feat = _mel_frames(r), r["mc"].n_mels
    rng = np.random.default_rng(31)
    return {"t": rng.random((B, 1, 1)).astype(np.float32),
            "z": _rand(B, frames, feat, seed=32),
            "keep": {"asr": np.full((B, 1, 1), 0.5, np.float32),
                     "f0": np.full((B, 1), 0.5, np.float32),
                     "energy": np.full((B, 1), 0.5, np.float32)},
            "noise": _rand(B, frames, seed=33),
            "route": rng.random((B, frames)).astype(np.float32)}


def _torch_draws(d):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in d.items()}


@pytest.fixture(scope="module")
def cfm_steps(inputs):
    """Both stages' JAX train steps and the port's, each from the same
    weights."""
    r = inputs
    d = _train_draws(r)
    frames = _mel_frames(r)
    out = {}
    for stage, lr in (("cfm_hubert_pitch", LR_PITCH),
                      ("cfm_hubert_mel", LR_MEL)):
        state, ctx = jax_setup(r["mc_jax"], r["models"], r["params"],
                               r["stats"])
        uniform = {(B, 1, 1): [d["t"], d["keep"]["asr"]],
                   (B, 1): d["keep"]["f0"], (B, frames): d["route"]}
        with jax_small_nets(), jax_draws(
                uniform=uniform, normal={(B, frames, r["mc"].n_mels): d["z"],
                                         (B, frames): d["noise"]}):
            new_state, metrics = jax.jit(jax_train_step(stage, ctx, lr))(
                state, jax_batch(r["batch"]), jax.random.PRNGKey(0),
                _frozen(r))
            jax.block_until_ready(metrics)
        pstate, pctx = port_setup(r["mc"], r["params"], r["stats"],
                                  r["ssl"])
        before = model_states(pstate)
        pstate, pmetrics = make_train_step(stage, pctx, lr)(
            pstate, port_batch(r["batch"]), cfm_draws=_torch_draws(d))
        out[stage] = dict(jax_state=new_state, jax_metrics=metrics,
                          state=pstate, metrics=pmetrics, before=before)
    return out


LOSS_REL = 1e-3


@pytest.mark.parametrize("stage", ["cfm_hubert_pitch", "cfm_hubert_mel"])
def test_cfm_stage_loss_matches_jax(cfm_steps, stage):
    s = cfm_steps[stage]
    want = {k: float(v) for k, v in s["jax_metrics"].items()}
    got = {k: float(v) for k, v in s["metrics"].items()}
    names = {"cfm_hubert_pitch": {"normed_pitch_l2", "loss"},
             "cfm_hubert_mel": {"mel_l2", "loss"}}[stage]
    assert set(got) == set(want) == names
    for key, value in got.items():
        assert abs(value - want[key]) <= LOSS_REL * abs(want[key]), \
            (key, value, want[key])
    assert s["state"].step == 1


# f32 models on both sides: each gradient within 1e-3 of the module's
# largest and 1e-3 by relative L2, each parameter within 2 lr of the JAX
# update (AdamW's first step is lr * sign(grad) for all but near-zero
# gradients)
GRAD_TOL = 1e-3


@pytest.mark.parametrize("stage,key", [
    ("cfm_hubert_pitch", "cfm_pitch_predictor"),
    ("cfm_hubert_mel", "cfm_mel_decoder")])
def test_cfm_stage_update_matches_jax(cfm_steps, stage, key):
    s = cfm_steps[stage]
    lr = LR_PITCH if stage == "cfm_hubert_pitch" else LR_MEL
    check_update(s["jax_state"], s["state"], s["before"], key, GRAD_TOL,
                 GRAD_TOL, lr=lr)


def test_cfm_hubert_mel_decays_the_hubert_encoder(cfm_steps):
    """No loss applies the hubert encoder: its gradient is zero and AdamW's
    decoupled decay alone moves it, by exactly the factor 1 - lr * wd (the
    JAX package's p - lr * wd * p within an f32 ulp of it); the other
    models stay bit-equal."""
    s = cfm_steps["cfm_hubert_mel"]
    module = s["state"].models["hubert_encoder"]
    want_j = load_flax_params("hubert_encoder", flatten(
        s["jax_state"].params["hubert_encoder"]), module)
    moved = 0
    for name, p in module.named_parameters():
        before = s["before"]["hubert_encoder"][name]
        assert torch.equal(p.grad, torch.zeros_like(p)), name
        assert torch.equal(p.detach(), before.mul(1 - LR_MEL * WEIGHT_DECAY)
                           ), name
        moved += not torch.equal(p.detach(), before)
        np.testing.assert_allclose(p.detach().numpy(), want_j[name].numpy(),
                                   rtol=2.5e-7, atol=0, err_msg=name)
    assert moved > 0
    for name, t in s["state"].models["cfm_pitch_predictor"].state_dict(
            ).items():
        assert torch.equal(t, s["before"]["cfm_pitch_predictor"][name]), name


@pytest.mark.parametrize("variant", ["pitch", "griffin_lim", "vocos"])
def test_cfm_eval_matches_jax(inputs, variant):
    """``cfm_hubert_pitch``'s validation, and ``cfm_hubert_mel``'s 16-step
    Euler solve from the same noise auditioned through Griffin-Lim (the
    model's mel, the same initial phase) or through Vocos (Vocos's
    features, given weights): metrics within 1e-3 relative, audio within
    1e-4 of its peak (Griffin-Lim's within 1e-3: the atan2 of near-silent
    bins, see test_torch_port_ssl.py), the state unchanged."""
    r = inputs
    stage = "cfm_hubert_pitch" if variant == "pitch" else "cfm_hubert_mel"
    features = "vocos" if variant == "vocos" else "model"
    mc_jax, mc = experimental_config(features)
    models = jax_models(mc_jax)
    params, stats = model_params(mc_jax, models, KEYS, seed=60)
    vocos_p, vocos = small_vocos()
    audio = r["batch"]["audio_gt"]
    frames = (audio.shape[1] // 256 + 1 if features == "vocos"
              else _mel_frames(r))
    feat = 100 if features == "vocos" else mc.n_mels
    z, noise = _rand(B, frames, feat, seed=41), _rand(B, frames, seed=42)
    phase = np.random.default_rng(43).uniform(
        -np.pi, np.pi, (B, frames, mc.n_fft // 2 + 1)).astype(np.float32)
    state, ctx = jax_setup(mc_jax, models, params, stats)
    frozen = _frozen(r)
    if features == "vocos":
        frozen["vocos"] = vocos_p
    with jax_small_nets(), jax_draws(
            uniform={phase.shape: phase},
            normal={z.shape: z, noise.shape: noise}):
        metrics, jaudio = jax.jit(jax_eval_step(stage, ctx))(
            state, jax_batch(r["batch"]), jax.random.PRNGKey(0), frozen)
    pstate, pctx = port_setup(mc, params, stats, r["ssl"],
                              vocos=vocos if features == "vocos" else None)
    before = model_states(pstate)
    pmetrics, paudio = make_eval_step(stage, pctx)(
        pstate, port_batch(r["batch"]),
        cfm_draws={"z": torch.from_numpy(z), "noise": torch.from_numpy(noise),
                   "phase": torch.from_numpy(phase)})
    want = {k: float(v) for k, v in metrics.items()}
    got = {k: float(v) for k, v in pmetrics.items()}
    assert set(got) == set(want)
    for key, value in got.items():
        assert abs(value - want[key]) <= LOSS_REL * abs(want[key]), \
            (key, value, want[key])
    if variant == "pitch":
        assert paudio is None
    else:
        length = ((frames - 1) * 256 if features == "vocos"
                  else frames * mc.hop_length)
        assert paudio.shape == (B, length)
        assert float(paudio.abs().max()) > 0
        assert_close(paudio, np.asarray(jaudio),
                     rel=1e-3 if variant == "griffin_lim" else 1e-4,
                     what=variant)
    for key, module in pstate.models.items():
        for name, t in module.state_dict().items():
            assert torch.equal(t, before[key][name]), (key, name)

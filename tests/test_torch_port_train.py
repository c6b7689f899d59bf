"""One acoustic-stage train step of the port against the JAX package's
jitted ``make_train_step("acoustic", ...)`` at the tiny config, in f32,
plus the bf16 step, dropout, the GAN gradient routing and the weight
carrier of the training models.

Randomness is removed on both sides, never covered by a tolerance: every
dropout is off (the JAX side's ``nn.Dropout`` is patched to the identity
inside the reference fixture, the port's rates are set to 0), the latent
noise is zero (``jax.random.normal`` patched to zeros; ``sample=False`` on
the port) and the harmonic prior gets the same numpy noise and phase 0.
"""

from __future__ import annotations

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.models.generator as jgen
from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.models.discriminator import \
    MultiResolutionDiscriminator as JaxMRD
from stylish_tts_tpu.train.init import build_train_state as jax_train_state
from stylish_tts_tpu.train.stages import StageContext as JaxContext
from stylish_tts_tpu.train.stages import make_train_step as jax_train_step
from stylish_tts_tpu_torch.config import Config, load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models.discriminator import \
    MultiResolutionDiscriminator
from stylish_tts_tpu_torch.models.norms import Dropout
from stylish_tts_tpu_torch.train.init import build_train_state
from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                gan_losses, make_train_step)
from test_torch_port_helpers import (TRAIN_KEYS, acoustic_batch,
                                     fill_params, flatten, load_train_models,
                                     param_shapes, train_config, train_params)

LR = 1e-4
NOISE_AMPLITUDE = 0.01  # generate_pcph's default
MEL_MEAN, MEL_STD, STEP_LIMIT = -4.0, 4.0, 100


def _no_dropout(models):
    for model in models.values():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return models


def _port_state(mc, params, stats, mixed="no"):
    models, slm = load_train_models(mc, params, stats)
    state = build_train_state(mc, TRAIN_KEYS, models=_no_dropout(models),
                              device="cpu")
    cfg = Config()
    cfg.training.mixed_precision = mixed
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=MEL_MEAN,
                       mel_std=MEL_STD, step_limit=STEP_LIMIT, slm=slm)
    return state, ctx


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """The JAX step's result, traced and run once for the module."""
    mc_jax = train_config()
    mc = load_model_config_json(mc_jax.model_dump_json())
    params, stats = train_params(mc_jax, seed=7)
    batch, noise = acoustic_batch(mc_jax, seed=3)
    cfg = JaxConfig()
    cfg.training.mixed_precision = "no"
    variables = {k: {"params": params[k]} for k in TRAIN_KEYS}
    variables["pe_mel_style_encoder"]["batch_stats"] = stats
    state = jax_train_state(variables, mc_jax)
    ctx = JaxContext(models=jax_build_models(mc_jax), model_config=mc_jax,
                     config=cfg, mel_mean=MEL_MEAN, mel_std=MEL_STD,
                     step_limit=STEP_LIMIT)
    original = jgen.generate_pcph

    def shared_noise_pcph(f0, voiced, rng, **kwargs):
        kwargs.update(noise_amplitude=0.0, random_init_phase=False)
        return original(f0, voiced, rng, **kwargs) \
            + NOISE_AMPLITUDE * jnp.asarray(noise)

    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
              for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape,
                                                                      dtype))
        mp.setattr(jgen, "generate_pcph", shared_noise_pcph)
        step = jax.jit(jax_train_step("acoustic", ctx, LR))
        new_state, metrics = step(state, jbatch, jax.random.PRNGKey(0),
                                  {"slm": params["slm"]})
    jax.block_until_ready(metrics)
    return dict(mc=mc, params=params, stats=stats, batch=batch, noise=noise,
                state=new_state, metrics=metrics)


@pytest.fixture(scope="module")
def port_step(reference):
    r = reference
    state, ctx = _port_state(r["mc"], r["params"], r["stats"])
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in state.models.items()}
    step = make_train_step("acoustic", ctx, LR)
    state, metrics = step(
        state, _port_batch(r["batch"]), sample=False,
        pcph_noise=torch.from_numpy(r["noise"]), pcph_phase=torch.zeros(1, 1))
    return state, metrics, before


# f32 terms: tens of f32 layers, the STFTs and the mel filterbank summed in
# another order (measured: at most 9e-7 relative)
F32_TERMS = {"mel": 1e-5, "mag": 1e-5, "phase": 1e-5, "pitch": 1e-5,
             "energy": 1e-5}
# bf16 terms: the MRD and the SLM run in bf16 on both sides (2^-8 per
# rounding), through XLA's convs on one side and f32 sums of the same bf16
# values on the other (measured: at most 4e-4 relative)
BF16_TERMS = {"slm": 5e-3, "generator": 5e-3, "discriminator": 5e-3}


def test_acoustic_step_metrics_match_jax(reference, port_step):
    _, metrics, _ = port_step
    want = {k: float(v) for k, v in reference["metrics"].items()}
    assert set(metrics) == set(want)
    for key, rel in {**F32_TERMS, **BF16_TERMS}.items():
        got = float(metrics[key])
        assert abs(got - want[key]) <= rel * abs(want[key]), \
            (key, got, want[key])
    # the total is dominated by the f32 terms; the bf16 ones are < 5 % of it
    # (measured: 1.6e-5 relative)
    assert abs(float(metrics["loss"]) - want["loss"]) <= 2e-4 * want["loss"]


# each module's gradient against the JAX step's.  The f32 modules get theirs
# only through the f32 pitch/energy losses: within 1e-4 of the module's
# largest gradient (measured 6e-6).  The speech predictor's also runs back
# through the bf16 MRD (generator loss) and the bf16 SLM, and the MRD's
# through its own bf16 forward and backward; JAX's bf16 MRD gradient is
# itself up to 8 % of the module's largest value off its f32 one (measured
# on random inputs in test_gan_routing_matches_two_view_jax's setting, the
# port's 2 %), so these two are held by the module's relative L2 error and
# loosely by the max (measured with 1 to 8 CPU threads: speech predictor
# 4.1-4.4 % and 4.1-6.9 %, where the thread count reorders the port's bf16
# sums; MRD 5.4 % and 29 %, where one bias gradient sums thousands of bf16
# terms).
MAX_TOL = {"pitch_energy_predictor": 1e-4, "pe_text_encoder": 1e-4,
           "pe_mel_style_encoder": 1e-4, "speech_predictor": 0.15,
           "mrd": 0.4}
L2_TOL = {"pitch_energy_predictor": 1e-4, "pe_text_encoder": 1e-4,
          "pe_mel_style_encoder": 1e-4, "speech_predictor": 0.1, "mrd": 0.15}


@pytest.mark.parametrize("key", TRAIN_KEYS)
def test_acoustic_step_gradients_and_updates_match_jax(reference, port_step,
                                                       key):
    state, _, before = port_step
    module = state.models[key]
    stats = flatten(reference["stats"]) if key == "pe_mel_style_encoder" \
        else {}
    # the first AdamW moment after one step is (1 - b1) * grad on both sides
    mu = flatten(reference["state"].opt_states[key].inner_state[0].mu)
    grads_j = {n: v / 0.15 for n, v in
               load_flax_params(key, {**mu, **stats}, module).items()}
    new = load_flax_params(
        key, {**flatten(reference["state"].params[key]), **stats}, module)
    largest = max(float(grads_j[n].abs().max()) for n in before[key])
    worst = diff2 = ref2 = 0.0
    for name, p in module.named_parameters():
        diff = p.grad - grads_j[name]
        worst = max(worst, float(diff.abs().max()))
        diff2 += float(diff.square().sum())
        ref2 += float(grads_j[name].square().sum())
        # post-step parameters: AdamW's first step moves each by about
        # lr * sign(grad), so a near-zero gradient may flip: within 2 lr
        step_err = float((p.detach() - new[name]).abs().max())
        assert step_err <= 2 * LR * (1 + 1e-3), (name, step_err)
    # the module moved (a parameter the loss does not reach only decays,
    # by lr * 1e-4 of itself, which f32 may not resolve)
    assert any(not torch.equal(p.detach(), before[key][n])
               for n, p in module.named_parameters()), key
    assert worst <= MAX_TOL[key] * largest, (key, worst, largest)
    assert diff2 ** 0.5 <= L2_TOL[key] * ref2 ** 0.5, (key, diff2, ref2)


def test_acoustic_step_updates_ema_and_batch_stats(reference, port_step):
    state, metrics, _ = port_step
    ema_j = float(reference["state"].disc_ema["mrd"])
    ema = float(state.disc_ema["mrd"])
    assert ema != 1.5
    # 0.05 of the plain LSGAN loss, a bf16 MRD term (see BF16_TERMS)
    assert abs(ema - ema_j) <= 0.05 * 1e-2 * abs(ema_j)
    module = state.models["pe_mel_style_encoder"]
    params = flatten(reference["params"]["pe_mel_style_encoder"])
    stats_j = load_flax_params("pe_mel_style_encoder", {
        **params,
        **flatten(reference["state"].batch_stats["pe_mel_style_encoder"])},
        module)
    init = load_flax_params("pe_mel_style_encoder",
                            {**params, **flatten(reference["stats"])}, module)
    for name, buf in module.named_buffers():
        # one f32 power-iteration step on the same kernels
        np.testing.assert_allclose(buf.numpy(), stats_j[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        assert not torch.equal(buf, init[name]), name  # the step stored it


def test_bf16_step_runs_near_f32(reference, port_step):
    r = reference
    _, metrics_f32, _ = port_step
    state, ctx = _port_state(r["mc"], r["params"], r["stats"], mixed="bf16")
    step = make_train_step("acoustic", ctx, LR)
    _, metrics = step(state, _port_batch(r["batch"]), sample=False,
                      pcph_noise=torch.from_numpy(r["noise"]),
                      pcph_phase=torch.zeros(1, 1))
    for key, value in metrics.items():
        assert torch.isfinite(value), key
        # bf16 modules over a few tens of layers: within 5 % of f32
        want = float(metrics_f32[key])
        assert abs(float(value) - want) <= 5e-2 * abs(want), (key, value,
                                                              want)


def test_dropout_is_active_only_in_train_mode():
    from stylish_tts_tpu_torch.models import build_models
    from stylish_tts_tpu_torch.models.norms import set_dropout_generator

    mc = load_model_config_json(train_config().model_dump_json())
    mc.text_encoder.dropout = 0.2
    enc = build_models(mc)["pe_text_encoder"]
    tokens = torch.randint(1, 100, (2, 9), generator=torch.Generator()
                           .manual_seed(0))
    lengths = torch.tensor([9, 7])
    assert not enc.training  # eval by default: off outside training
    with torch.no_grad():
        a = enc(tokens, lengths)[0]
        enc.train()
        set_dropout_generator(enc, torch.Generator().manual_seed(1))
        b = enc(tokens, lengths)[0]
        set_dropout_generator(enc, torch.Generator().manual_seed(1))
        c = enc(tokens, lengths)[0]
        enc.eval()
        d = enc(tokens, lengths)[0]
    assert not torch.equal(a, b)  # masks applied in train mode
    torch.testing.assert_close(b, c, rtol=0, atol=0)  # from the generator
    torch.testing.assert_close(a, d, rtol=0, atol=0)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gan_routing_matches_two_view_jax():
    """Generator-loss gradients reach the predicted images only, the
    discriminator loss's the MRD only: in f32 against the JAX package's two
    detached views; in bf16, no further from the f32 gradients than the JAX
    package's bf16 views are."""
    rng = np.random.default_rng(0)
    shapes = [(2, 257, 25, 1), (2, 513, 11, 1)]
    t_np = [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]
    p_np = [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]
    disc = JaxMRD(resolution_count=2)
    params = fill_params(param_shapes(disc, t_np, t_np), seed=4)
    sg = functools.partial(jax.tree_util.tree_map, jax.lax.stop_gradient)

    def two_view(p, t, f, dtype):
        cast = functools.partial(jax.tree_util.tree_map,
                                 lambda a: a.astype(dtype))
        f32 = functools.partial(jax.tree_util.tree_map,
                                lambda a: a.astype(jnp.float32))
        p, t, f = cast(p), cast(t), cast(f)
        g_rs, g_gs, g_rf, g_gf = f32(disc.apply({"params": sg(p)}, sg(t), f))
        gen = JL.generator_adversarial_loss(g_rs, g_gs, g_rf, g_gf)
        d_rs, d_gs, _, _ = f32(disc.apply({"params": p}, sg(t), sg(f)))
        d_total, _ = JL.discriminator_loss(d_rs, d_gs)
        return gen + 3.0 * d_total

    grad = jax.jit(jax.grad(two_view, argnums=(0, 2)), static_argnums=3)
    mrd = MultiResolutionDiscriminator(2)
    mrd.load_state_dict(load_flax_params("mrd", flatten(params), mrd))
    ref = {}
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        gp, gf = grad(params, t_np, p_np, jdtype)
        mrd.zero_grad()
        f = [torch.from_numpy(a).requires_grad_() for a in p_np]
        gen, d_total, _ = gan_losses(mrd, [torch.from_numpy(a) for a in t_np],
                                     f, dtype=dtype)
        (gen + 3.0 * d_total).backward()
        ref[dtype] = (load_flax_params("mrd", flatten(gp), mrd),
                      [np.asarray(g, np.float32) for g in gf],
                      {n: p.grad.clone() for n, p in mrd.named_parameters()},
                      [x.grad.numpy() for x in f])
    want_p, want_f, got_p, got_f = ref[torch.float32]
    largest = max(float(v.abs().max()) for v in want_p.values())
    for name, g in got_p.items():
        err = float((g - want_p[name]).abs().max())
        assert err <= 1e-5 * largest, (name, err, largest)  # f32 sums
    # the images' gradients hold the sign of |real - fake| feature
    # differences, which flips where the two are nearly equal: 1e-3
    for got, want in zip(got_f, want_f):
        err = float(np.abs(got - want).max())
        assert err <= 1e-3 * np.abs(want).max(), err
    # bf16: the MRD's gradient within JAX's own bf16 error of the f32 one
    # (measured: port 2 %, JAX 8 % of the largest); the images' in relative
    # L2 within 1.25x of JAX's (measured: port 58 % and 13 %, JAX 54 % and
    # 19 %: bf16 feature maps flip many of those signs)
    jax_p, jax_f, port_p, port_f = ref[torch.bfloat16]
    port_err = max(float((port_p[n] - want_p[n]).abs().max()) for n in want_p)
    jax_err = max(float((jax_p[n] - want_p[n]).abs().max()) for n in want_p)
    assert port_err <= jax_err, (port_err, jax_err)
    for port, jaxs, want in zip(port_f, jax_f, want_f):
        assert _rel_l2(port, want) <= 1.25 * _rel_l2(jaxs, want)


def test_weight_carrier_fills_the_training_models():
    mc_jax = train_config()
    mc = load_model_config_json(mc_jax.model_dump_json())
    params, stats = train_params(mc_jax, seed=1)
    models, slm = load_train_models(mc, params, stats)
    for key, module in [*models.items(), ("slm", slm)]:
        flat = flatten(params[key])
        if key == "pe_mel_style_encoder":
            flat.update(flatten(stats))
        state = load_flax_params(key, flat, module)
        # every flax key used, every parameter and buffer filled
        assert set(state) == set(module.state_dict()), key
        assert len(flat) == len(state), key
    assert models["speech_predictor"].posterior_encoder is not None
    with pytest.raises(KeyError, match="left unfilled"):
        flat = flatten(params["mrd"])
        flat.pop("disc_1/WeightNorm_2/conv_2/kernel/scale")
        load_flax_params("mrd", flat, models["mrd"])
    assert STAGES["acoustic"].discriminators == ["mrd"]

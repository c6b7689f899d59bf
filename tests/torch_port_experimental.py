"""Shared setup of the experimental-stage parity tests
(``test_torch_port_ssl.py``, ``test_torch_port_hubert.py``,
``test_torch_port_cfm.py``): a tiny config, seeded flax weights of each
module loaded into both packages, small frozen HuBERT and speaker nets on
both sides (the JAX stage context builds its own from the config, so its
two classes are patched to the small sizes inside ``jax_small_nets``), and
each side's f32 stage context.

Random draws that no two frameworks share (CFM's t, z and condition-drop
uniforms, the TREAD route, the sine source's noise, Griffin-Lim's phase)
are handed to the port and patched into ``jax.random`` by shape
(``jax_draws``).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.models.vocos as jvocos
import stylish_tts_tpu.train.stages as jstages
from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.models.ssl import AdaptiveHubert as JaxHubert
from stylish_tts_tpu.models.ssl import SpeakerEmbeddingModel as JaxSpeaker
from stylish_tts_tpu.models.vocos import Vocos as JaxVocos
from stylish_tts_tpu.train.init import build_train_state as jax_train_state
from stylish_tts_tpu.train.stages import StageContext as JaxContext
from stylish_tts_tpu_torch.config import Config, load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models.norms import Dropout
from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
from stylish_tts_tpu_torch.models.ssl import (AdaptiveHubert,
                                              SpeakerEmbeddingModel)
from stylish_tts_tpu_torch.models.vocos import Vocos
from stylish_tts_tpu_torch.train.init import (build_train_state,
                                              build_training_models)
from stylish_tts_tpu_torch.train.stages import StageContext
from test_torch_port_helpers import (fill_params, flatten, param_shapes,
                                     train_config)

LR = 1e-4
MEL_MEAN, MEL_STD, STEP_LIMIT = -4.0, 4.0, 100
F0_LOG2_MEAN, F0_LOG2_STD = 7.3, 0.4
# the small frozen nets: a 1-layer HuBERT encoder, a SimAM-ResNet34 of 4
# base channels (natural width 640, so ``proj`` maps it to the config's
# speaker width), a 2-block Vocos
HUBERT_LAYERS, SPEAKER_CHANNELS = 1, 4
VOCOS_SMALL = dict(dim=32, intermediate_dim=48, n_layers=2)
HUBERT_DIM, SPEAKER_DIM = 64, 96
SPEAKER_LEVEL = 0.07
# the CFM models at narrow widths: their defaults set most of a step's time
# on the CPU (the JAX registry's are overridden the same way)
CFM_PITCH = dict(hidden_dim=32)
CFM_MEL = dict(hidden_dim=64, emb_dim=32, xut_depth=2, xut_heads=4,
               tread_post_depth=1)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs: the suite runs test
    files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def experimental_config(features: str = "model"):
    """(JAX config, port config): ``train_config`` with a 64-wide HuBERT
    projection and a 96-wide speaker vector."""
    mc = train_config()
    mc.hubert.hidden_dim = HUBERT_DIM
    mc.speaker_embedder.hidden_dim = SPEAKER_DIM
    mc.cfm_mel_features = features
    return mc, load_model_config_json(mc.model_dump_json())


def seeded(shapes, seed: int):
    """``fill_params`` of ``shapes`` with every batch-norm ``var`` made
    positive (0.5 + |x|)."""
    params = fill_params(shapes, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.abs(v) + 0.5 if str(path[-1].key) == "var"
        else v, params)


def port_module(module, params, name="module"):
    """``module`` carrying the flax ``params``, eval mode, dropout 0."""
    module.load_state_dict(load_flax_params(name, flatten(params), module))
    for m in module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return module.eval()


def small_nets(mc_jax, seed: int = 20):
    """The small frozen nets' flax params and their port modules:
    (hubert params, speaker params, (port hubert, port speaker))."""
    hub = JaxHubert(model_sr=mc_jax.sample_rate, hubert_sr=mc_jax.hubert.sr,
                    proj_dim=mc_jax.hubert.hidden_dim,
                    n_layers=HUBERT_LAYERS)
    spk = JaxSpeaker(model_sr=mc_jax.sample_rate,
                     hidden_dim=mc_jax.speaker_embedder.hidden_dim,
                     m_channels=SPEAKER_CHANNELS)
    wave = jnp.zeros((1, 4800))
    hub_p = seeded(param_shapes(hub, wave, 12), seed)
    spk_p = seeded(param_shapes(spk, wave), seed + 1)
    # a speaker vector of unit scale, as a trained net's: the seeded
    # statistics reach a std of 14, which the predictors' AdaLN and AdaIN
    # gains multiply into their outputs' rounding
    spk_p["proj"] = {k: v * SPEAKER_LEVEL for k, v in spk_p["proj"].items()}
    ports = (
        port_module(AdaptiveHubert(model_sr=mc_jax.sample_rate,
                                   hubert_sr=mc_jax.hubert.sr,
                                   proj_dim=mc_jax.hubert.hidden_dim,
                                   n_layers=HUBERT_LAYERS), hub_p),
        port_module(SpeakerEmbeddingModel(
            model_sr=mc_jax.sample_rate,
            hidden_dim=mc_jax.speaker_embedder.hidden_dim,
            m_channels=SPEAKER_CHANNELS), spk_p))
    return hub_p, spk_p, ports


def small_vocos(seed: int = 30):
    """(flax params of the small Vocos, the port's)."""
    params = seeded(param_shapes(JaxVocos(**VOCOS_SMALL),
                                 jnp.zeros((1, 8, 100))), seed)
    return params, port_module(Vocos(**VOCOS_SMALL), params)


@contextlib.contextmanager
def jax_small_nets():
    """The JAX stage context's frozen nets and Vocos at the small sizes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstages, "AdaptiveHubert",
                   functools.partial(JaxHubert, n_layers=HUBERT_LAYERS))
        mp.setattr(jstages, "SpeakerEmbeddingModel",
                   functools.partial(JaxSpeaker,
                                     m_channels=SPEAKER_CHANNELS))
        mp.setattr(jvocos, "Vocos", functools.partial(JaxVocos,
                                                      **VOCOS_SMALL))
        yield


@contextlib.contextmanager
def jax_draws(uniform=None, normal=None, no_dropout=True):
    """``jax.random.uniform`` and ``normal`` answer from ``uniform`` and
    ``normal``: dicts from a shape to an array, or to a list of arrays
    handed out in call order (the last one repeats); flax's dropout is
    the identity."""
    import flax.linen

    def answer(table, shape, kind):
        value = table[tuple(shape)]
        if isinstance(value, list):
            value = value.pop(0) if len(value) > 1 else value[0]
        assert tuple(value.shape) == tuple(shape), (kind, shape)
        return jnp.asarray(value)

    with pytest.MonkeyPatch.context() as mp:
        if uniform is not None:
            mp.setattr(jax.random, "uniform",
                       lambda key, shape=(), dtype=jnp.float32, minval=0.0,
                       maxval=1.0: answer(uniform, shape, "uniform"))
        if normal is not None:
            mp.setattr(jax.random, "normal",
                       lambda key, shape=(), dtype=jnp.float32:
                       answer(normal, shape, "normal"))
        if no_dropout:
            mp.setattr(flax.linen.Dropout, "__call__",
                       lambda self, x, *a, **k: x)
        yield


def jax_models(mc_jax):
    """The JAX registry with the CFM models at their narrow widths."""
    from stylish_tts_tpu.models.cfm_mel_decoder import CfmMelDecoder
    from stylish_tts_tpu.models.cfm_pitch_predictor import CfmPitchPredictor

    models = jax_build_models(mc_jax)
    models["cfm_pitch_predictor"] = CfmPitchPredictor(
        asr_dim=mc_jax.hubert.hidden_dim, n_mels=mc_jax.n_mels, **CFM_PITCH)
    models["cfm_mel_decoder"] = CfmMelDecoder(
        feat_dim=100 if mc_jax.cfm_mel_features == "vocos" else
        mc_jax.n_mels, asr_dim=mc_jax.hubert.hidden_dim,
        spk_dim=mc_jax.speaker_embedder.hidden_dim, **CFM_MEL)
    return models


def port_models(mc, keys):
    """The port's models of ``keys`` with the CFM models at the same
    narrow widths."""
    from stylish_tts_tpu_torch.models.cfm_mel_decoder import CfmMelDecoder
    from stylish_tts_tpu_torch.models.cfm_pitch_predictor import \
        CfmPitchPredictor

    models = build_training_models(mc, [k for k in keys if not
                                        k.startswith("cfm")])
    if "cfm_pitch_predictor" in keys:
        models["cfm_pitch_predictor"] = CfmPitchPredictor(
            asr_dim=mc.hubert.hidden_dim, n_mels=mc.n_mels, **CFM_PITCH)
    if "cfm_mel_decoder" in keys:
        models["cfm_mel_decoder"] = CfmMelDecoder(
            feat_dim=100 if mc.cfm_mel_features == "vocos" else mc.n_mels,
            asr_dim=mc.hubert.hidden_dim,
            spk_dim=mc.speaker_embedder.hidden_dim, **CFM_MEL)
    return models


def init_args(mc_jax, key: str):
    """The JAX init arguments of model ``key`` (``init_model_variables``'
    dummy shapes)."""
    b, f = 1, 12
    hubert = jnp.zeros((b, f, mc_jax.hubert.hidden_dim))
    lengths = jnp.full((b,), f, jnp.int32)
    spk = jnp.zeros((b, mc_jax.speaker_embedder.hidden_dim))
    pitch, energy = jnp.full((b, f), 100.0), jnp.ones((b, f))
    feat = 100 if mc_jax.cfm_mel_features == "vocos" else mc_jax.n_mels
    return {
        "hubert_encoder": (hubert, lengths),
        "hubert_speech_predictor": (hubert, lengths, spk, pitch, energy,
                                    jnp.zeros((b, f * mc_jax.hop_length))),
        "hubert_pitch_energy_predictor": (hubert, lengths, spk),
        "cfm_pitch_predictor": (hubert, jnp.zeros((b, f, mc_jax.n_mels))),
        "cfm_mel_decoder": (jnp.zeros((b, f, feat)), jnp.zeros((b,)),
                            hubert, pitch, energy, spk),
    }[key]


def model_params(mc_jax, models, keys, seed: int):
    """({key: flax params}, {key: batch stats}) of ``keys``, every leaf
    drawn from ``seed``; the spectral-norm ``u`` standard normal, its
    ``sigma`` 1."""
    params, stats = {}, {}
    key0 = jax.random.PRNGKey(0)
    rngs = {"params": key0, "sample": key0, "dropout": key0}
    for i, key in enumerate(keys):
        if key in ("mrd",):
            continue
        shapes = jax.eval_shape(lambda k=key: models[k].init(
            rngs, *init_args(mc_jax, k)))
        params[key] = seeded(shapes["params"], seed + i)
        if "batch_stats" in shapes:
            rng = np.random.default_rng(seed + 100 + i)
            stats[key] = jax.tree_util.tree_map_with_path(
                lambda path, s: jnp.asarray(
                    rng.standard_normal(s.shape).astype(np.float32)
                    if str(path[-1].key).endswith("u")
                    else np.ones(s.shape, np.float32)), shapes["batch_stats"])
    return params, stats


def jax_setup(mc_jax, models, params, stats):
    """(JAX train state, f32 stage context) of ``params``."""
    cfg = JaxConfig()
    cfg.training.mixed_precision = "no"
    variables = {k: {"params": v} for k, v in params.items()}
    for k, v in stats.items():
        variables[k]["batch_stats"] = v
    state = jax_train_state(variables, mc_jax)
    ctx = JaxContext(models=models, model_config=mc_jax, config=cfg,
                     mel_mean=MEL_MEAN, mel_std=MEL_STD,
                     step_limit=STEP_LIMIT, f0_log2_mean=F0_LOG2_MEAN,
                     f0_log2_std=F0_LOG2_STD)
    return state, ctx


def port_setup(mc, params, stats, ssl, slm=None, vocos=None):
    """(port train state, f32 stage context) of the same weights."""
    built = port_models(mc, list(params))
    models = {}
    for key in params:
        flat = flatten(params[key])
        flat.update(flatten(stats.get(key, {})))
        built[key].load_state_dict(load_flax_params(key, flat, built[key]))
        for m in built[key].modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        models[key] = built[key]
    state = build_train_state(mc, list(models), models=models, device="cpu")
    cfg = Config()
    cfg.training.mixed_precision = "no"
    if slm is not None:
        module = SLMFeatureExtractor(n_layers=mc.slm.layers).eval()
        module.load_state_dict(load_flax_params("slm", flatten(slm), module))
        slm = module
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=MEL_MEAN,
                       mel_std=MEL_STD, step_limit=STEP_LIMIT, slm=slm,
                       ssl=ssl, vocos=vocos, f0_log2_mean=F0_LOG2_MEAN,
                       f0_log2_std=F0_LOG2_STD)
    return state, ctx


def jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def check_update(jax_state, state, before, key, max_tol, l2_tol, lr=LR):
    """The port's gradient and update of model ``key`` against the JAX
    step's (the limits of ``test_torch_port_joint.py``): the gradient
    within ``max_tol`` of the module's largest and ``l2_tol`` by relative
    L2, each parameter within 2 lr of the JAX update, the module moved."""
    module = state.models[key]
    mu = flatten(jax_state.opt_states[key].inner_state[0].mu)
    stats = flatten(jax_state.batch_stats.get(key, {}))
    # the first AdamW moment after one step is (1 - b1) * grad
    grads = {n: v / 0.15 for n, v in
             load_flax_params(key, {**mu, **stats}, module).items()}
    new = load_flax_params(key, {**flatten(jax_state.params[key]), **stats},
                           module)
    largest = max(float(grads[n].abs().max())
                  for n, _ in module.named_parameters())
    worst = diff2 = ref2 = 0.0
    for name, p in module.named_parameters():
        assert p.grad is not None, (key, name)
        diff = p.grad - grads[name]
        worst = max(worst, float(diff.abs().max()))
        diff2 += float(diff.square().sum())
        ref2 += float(grads[name].square().sum())
        step_err = float((p.detach() - new[name]).abs().max())
        assert step_err <= 2 * lr * (1 + 1e-3), (key, name, step_err)
    assert worst <= max_tol * largest, (key, worst, largest)
    assert diff2 ** 0.5 <= l2_tol * ref2 ** 0.5, (key, diff2, ref2)
    assert any(not torch.equal(p.detach(), before[key][n])
               for n, p in module.named_parameters()), key
    return worst / largest, (diff2 / ref2) ** 0.5


def model_states(state):
    return {k: {n: t.clone() for n, t in m.state_dict().items()}
            for k, m in state.models.items()}

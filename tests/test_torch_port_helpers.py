"""Shared helpers of the PyTorch-port parity tests, and the tests of the
port's weight, config, token and artifact plumbing.

Every parameter is drawn from a numpy seed (not from init: zero-initialised
heads would hide mapping errors) and loaded into both sides: into flax as it
is, into the port through ``load_flax_params``.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.utils.synthetic import tiny_model_config
from stylish_tts_tpu_torch.config import load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params

# f32 on both sides; the sums run in another order, so modules agree to a
# few f32 ulps of their largest output, bounded well above that here
MODULE_REL = 1e-4
MODULE_ABS = 1e-5


def flatten(params) -> dict:
    """Nested flax params -> {"a/b/kernel": np.ndarray}."""
    flat = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", "?")))
                        for p in keypath)
        flat[name] = np.asarray(leaf)
    return flat


def _fill_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    leaf = name.rsplit("/", 1)[-1]
    normal = rng.standard_normal(shape).astype(np.float32)
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return normal / np.float32(np.sqrt(fan_in))
    if leaf == "embedding":
        return normal / np.float32(np.sqrt(shape[-1]))
    if leaf in ("scale", "gamma"):
        return 1.0 + 0.1 * normal
    return 0.1 * normal  # bias, beta


def param_shapes(module, *args, **kwargs):
    """The shapes of ``module``'s params for ``args`` (traced, not run)."""
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "sample": key, "dropout": key}
    return jax.eval_shape(
        lambda: module.init(rngs, *args, **kwargs))["params"]


def seeded_params(module, *args, seed: int = 0, **kwargs):
    """Params of ``module`` for ``args``, every leaf drawn from ``seed``."""
    return fill_params(param_shapes(module, *args, **kwargs), seed)


def fill_params(shapes, seed: int):
    """A params tree of ``shapes``, every leaf drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    filled = [
        jnp.asarray(_fill_leaf(
            "/".join(str(getattr(p, "key", "?")) for p in keypath),
            leaf.shape, rng))
        for keypath, leaf in leaves
    ]
    return jax.tree_util.tree_unflatten(treedef, filled)


def load_port(module: torch.nn.Module, params, model_name: str = "module"):
    """Fill ``module`` from flax ``params`` through ``load_flax_params``."""
    module.load_state_dict(load_flax_params(model_name, flatten(params),
                                            module))
    return module.eval()


def assert_close(port, ref, *, rel=MODULE_REL, abs_=MODULE_ABS, what=""):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.all(np.isfinite(port)), what
    err = float(np.max(np.abs(port - ref))) if ref.size else 0.0
    bound = rel * float(np.max(np.abs(ref))) + abs_
    assert err <= bound, f"{what}: max|port-ref| {err:.3e} > {bound:.3e}"


PITCH_STEP = 24000 / 512  # Hz: f0/sr is then a multiple of 1/512
ONSET = 3  # unvoiced mel frames at the start


def well_posed_prior_inputs(pitch: np.ndarray, noise: np.ndarray):
    """Pitch and prior noise on which the two sides' priors agree to the
    ulp and every phase of their STFT is defined by the signal, not by
    rounding.  Two spots are ill-posed on any implementation:

    * the phase integral is an f32 cumsum over frames that XLA and torch
      sum in different orders; on a 24000/512 Hz grid every partial sum
      (through the x4 interpolation) is exact;
    * STFT frame 0 is centred on sample 0 of a reflect-padded signal, so
      it is exactly symmetric and each bin is real: its phase is 0 or ±π
      with the sign of the rounding.  An unvoiced, noise-free onset makes
      that frame exactly zero on both sides (phase 0)."""
    pitch = np.clip(np.round(pitch / PITCH_STEP), 2, 6) * PITCH_STEP
    pitch[:, :ONSET] = 0.0
    noise = noise.copy()
    noise[:, : (ONSET * 4 - 2) * 75] = 0.0  # prior exactly 0 under frame 0
    return pitch.astype(np.float32), noise


def speech_level(params):
    """Bring three seeded heads to the levels of a trained model: an F0 of
    speech (unit random weights give a few Hz: all unvoiced, no harmonic
    prior), small prior and flow heads, so exp(logstd) neither overflows
    nor compounds over the 8 flows, and a log-amplitude that keeps the iSTFT
    output out of the final tanh's saturation, where both sides would read
    +-1."""
    if "pitch_energy_predictor" in params:
        f0 = params["pitch_energy_predictor"]["f0_proj"]
        f0["kernel"] = 50.0 * f0["kernel"]
        f0["bias"] = f0["bias"] + 180.0  # Hz
    sp = params["speech_predictor"]
    heads = [sp["prior_encoder"], *sp["flow"].values()]
    if "posterior_encoder" in sp:
        heads.append(sp["posterior_encoder"])
    for layer in heads:
        for head in ("proj_mean", "proj_logstd"):
            layer[head]["kernel"] = 0.1 * layer[head]["kernel"]
    conv = sp["generator"]["amp_output_conv"]["Conv_0"]
    conv["kernel"] = 0.1 * conv["kernel"]
    return params


# --------------------------------------------------------------------------- #


def _inference_params(mc, seed=0):
    shapes = _inference_shapes(mc.model_dump_json())
    return {k: fill_params(v, seed + i)
            for i, (k, v) in enumerate(shapes.items())}


@functools.lru_cache(maxsize=2)
def _inference_shapes(mc_json: str):
    """Param shapes of the five inference models; tracing them is the
    costly part, so each config is traced once per process."""
    from stylish_tts_tpu.config import ModelConfig
    from stylish_tts_tpu.models import build_models
    from stylish_tts_tpu.train.init import INIT_F, INIT_T

    mc = ModelConfig.model_validate_json(mc_json)
    b, t, f = 1, INIT_T, INIT_F
    tokens = jnp.zeros((b, t), jnp.int32)
    lengths = jnp.full((b,), t, jnp.int32)
    align = jnp.zeros((b, t, f)).at[:, 0].set(1.0)
    pe_inter = jnp.zeros((b, t, mc.pitch_energy_predictor.inter_dim))
    style = jnp.zeros((b, mc.style_dim))
    args = {
        "duration_predictor": (tokens, lengths),
        "pe_text_encoder": (tokens, lengths),
        "pe_text_style_encoder": (pe_inter, lengths),
        "pitch_energy_predictor": (pe_inter, lengths, align, style),
        "speech_predictor": (tokens, lengths, align, jnp.full((b, f), 100.0),
                             jnp.ones((b, f)), jnp.zeros((b, f * 300))),
    }
    models = build_models(mc)
    return {k: param_shapes(models[k], *a) for k, a in args.items()}


def test_load_flax_params_fills_all_five_inference_models():
    from stylish_tts_tpu_torch.models import INFERENCE_MODELS, build_models

    mc_jax = tiny_model_config()
    mc = load_model_config_json(mc_jax.model_dump_json())
    params = _inference_params(mc_jax)
    port = build_models(mc)
    assert tuple(params) == INFERENCE_MODELS
    for key in INFERENCE_MODELS:
        flat = flatten(params[key])
        state = load_flax_params(key, flat, port[key])
        assert set(state) == set(port[key].state_dict()), key
        # every flax key went somewhere: tensor counts agree once the
        # declared training-only subtree is set aside
        kept = [n for n in flat if not n.startswith("posterior_encoder/")]
        assert len(kept) == len(state), key
    with pytest.raises(KeyError, match="left unused"):
        load_flax_params("pe_text_encoder",
                         {**flatten(params["pe_text_encoder"]),
                          "stray/kernel": np.zeros((2, 2), np.float32)},
                         port["pe_text_encoder"])
    flat = flatten(params["pe_text_encoder"])
    flat.pop("proj_m/bias")
    with pytest.raises(KeyError, match="left unfilled"):
        load_flax_params("pe_text_encoder", flat, port["pe_text_encoder"])


def test_model_config_json_round_trip():
    mc_jax = tiny_model_config()
    mc_jax.pitch_energy_predictor.reference_band_mask = True
    data = mc_jax.model_dump_json()
    mc = load_model_config_json(data)
    assert mc.state_dict() == json.loads(data)
    assert mc.text_encoder.hidden_dim == 64 and mc.generator.type == "freegan"
    with pytest.raises(ValueError, match="unknown keys"):
        load_model_config_json('{"no_such_field": 1}')


def test_text_cleaner_ids_match_jax_package():
    from stylish_tts_tpu.config import SymbolConfig
    from stylish_tts_tpu.text import TextCleaner as JaxCleaner
    from stylish_tts_tpu_torch.text import TextCleaner

    ref, port = JaxCleaner(), TextCleaner()
    sym = SymbolConfig()
    inventory = (sym.pad + sym.punctuation + sym.letters + sym.letters_ipa)
    assert port.word_index_dictionary == ref.word_index_dictionary
    assert port(inventory) == ref(inventory)
    assert port("ðɪs ɪz ə tˈɛst☃") == ref("ðɪs ɪz ə tˈɛst☃")


def test_safetensors_reader_matches_library(tmp_path):
    from safetensors.numpy import load_file, save_file

    from stylish_tts_tpu_torch.export.package import read_safetensors

    rng = np.random.default_rng(3)
    tensors = {
        "a/kernel": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "b/bias": rng.standard_normal(7).astype(np.float64),
        "c": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "d/scalar": np.array(2.5, np.float32),
        "e/empty": np.zeros((0, 3), np.float32),
    }
    path = tmp_path / "x.safetensors"
    save_file(tensors, str(path), metadata={"format": "np"})
    ref, got = load_file(str(path)), read_safetensors(path)
    assert set(ref) == set(got)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name])


# --------------------------------------------------------------------------- #
# the acoustic stage's training models


TRAIN_KEYS = ("speech_predictor", "pitch_energy_predictor", "pe_text_encoder",
              "pe_mel_style_encoder", "mrd")


def train_config():
    """The tiny config with a 1-layer SLM and every configurable dropout at
    0 (the hard-coded ones are switched off by the tests)."""
    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.text_encoder.dropout = 0.0
    mc.pitch_energy_predictor.dropout = 0.0
    return mc


@functools.lru_cache(maxsize=2)
def _train_shapes(mc_json: str):
    """Param (and batch-stat) shapes of the acoustic stage's models and the
    SLM, traced once per process."""
    from stylish_tts_tpu.config import ModelConfig
    from stylish_tts_tpu.models import build_models
    from stylish_tts_tpu.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu.train.init import INIT_F

    mc = ModelConfig.model_validate_json(mc_json)
    shapes = dict(_inference_shapes(mc_json))
    models = build_models(mc)
    key = jax.random.PRNGKey(0)
    mel = jnp.zeros((1, INIT_F, mc.n_mels))
    style = jax.eval_shape(lambda: models["pe_mel_style_encoder"].init(
        key, mel))
    images = [jnp.zeros((1, r // 2 + 1, INIT_F, 1)) for r in (512, 1024, 2048)]
    shapes["mrd"] = param_shapes(models["mrd"], images, images)
    shapes["pe_mel_style_encoder"] = style["params"]
    shapes["slm"] = param_shapes(SLMFeatureExtractor(n_layers=mc.slm.layers),
                                 jnp.zeros((1, 1600)))
    return ({k: shapes[k] for k in TRAIN_KEYS + ("slm",)},
            style["batch_stats"])


def train_params(mc, seed=0):
    """(params of the acoustic stage's models and the SLM, the mel style
    encoder's batch stats), every leaf from ``seed``: u standard normal,
    sigma 1."""
    shapes, stat_shapes = _train_shapes(mc.model_dump_json())
    params = {k: fill_params(v, seed + i) for i, (k, v) in
              enumerate(shapes.items())}
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(
            rng.standard_normal(s.shape).astype(np.float32)
            if str(path[-1].key).endswith("/u") else np.ones(s.shape,
                                                               np.float32)),
        stat_shapes)
    return speech_level(params), stats


def load_train_models(mc, params, stats):
    """The port's training models (and SLM) carrying the flax weights."""
    from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu_torch.train.init import build_training_models

    built = build_training_models(mc)
    models = {}
    for key in TRAIN_KEYS:
        flat = flatten(params[key])
        if key == "pe_mel_style_encoder":
            flat.update(flatten(stats))
        built[key].load_state_dict(load_flax_params(key, flat, built[key]))
        models[key] = built[key]
    slm = SLMFeatureExtractor(n_layers=mc.slm.layers)
    slm.load_state_dict(load_flax_params("slm", flatten(params["slm"]), slm))
    return models, slm.eval()


def acoustic_batch(mc, seed=0, batch=2, tokens=10, frames=24):
    """A numpy batch for the acoustic step: one-hot alignment whose
    durations sum to the frames, F0 on the well-posed grid with an unvoiced
    onset, harmonic ground-truth audio plus noise with a silent onset (the
    posterior encoder's frame 0 is then exactly zero on both sides, not a
    real spectrum whose phase is 0 or pi by the sign of a rounding), and
    the harmonic prior's noise."""
    rng = np.random.default_rng(seed)
    lengths = np.array([tokens] + [tokens - 2] * (batch - 1), np.int64)
    text = rng.integers(1, mc.text_encoder.tokens, (batch, tokens))
    alignment = np.zeros((batch, tokens, frames), np.float32)
    for b, n in enumerate(lengths):
        cuts = np.sort(rng.choice(np.arange(1, frames), n - 1, replace=False))
        for t, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, frames])):
            alignment[b, t, lo:hi] = 1.0
    hop = mc.hop_length
    noise = rng.standard_normal((batch, frames * hop)).astype(np.float32)
    pitch = 100.0 + 150.0 * rng.random((batch, frames))
    pitch, noise = well_posed_prior_inputs(pitch, noise)
    f0 = np.repeat(pitch, hop, axis=1)
    phase = 2 * np.pi * np.cumsum(f0 / mc.sample_rate, axis=1)
    audio = 0.3 * np.sin(phase) * (f0 > 0) \
        + 0.01 * rng.standard_normal(f0.shape)
    audio[:, : mc.n_fft // 2 + 1] = 0.0
    return dict(text=text, text_length=lengths, alignment=alignment,
                pitch=pitch, audio_gt=audio.astype(np.float32)), noise

"""Shared setup of the chain-stage parity tests
(``test_torch_port_stages.py``, ``test_torch_port_stages_eval.py``): the
weights of the chain's seven models drawn from a numpy seed and loaded
into both packages, the JAX side's noise fixed, and each side's f32 stage
context.
"""

from __future__ import annotations

import contextlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.models.generator as jgen
from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.train.init import build_train_state as jax_train_state
from stylish_tts_tpu.train.stages import StageContext as JaxContext
from stylish_tts_tpu_torch.config import Config, load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models.norms import Dropout
from stylish_tts_tpu_torch.train.init import (build_train_state,
                                              build_training_models)
from stylish_tts_tpu_torch.train.stages import StageContext
from test_torch_port_helpers import (TRAIN_KEYS, _inference_shapes,
                                     acoustic_batch, fill_params, flatten,
                                     train_config, train_params)

LR = 1e-4
# a voiced predicted F0 (chain_params' head) against the JAX
# package: the multi-resolution mel term within 2e-3 relative (measured
# 9.9e-5 to 4.2e-4 at the tiny config), the audio within 3e-2 of full
# scale (measured 1.3e-2 to 2.0e-2, on a peak of 0.035) and its STFT
# magnitudes within 25% by L2 (``spectral_distance``, measured 9.9-11.6%;
# the audio of an unvoiced F0 lies 53-55% away)
VOICED_MEL_REL, VOICED_AUDIO, VOICED_SPECTRAL = 2e-3, 3e-2, 0.25
NOISE_AMPLITUDE = 0.01  # generate_pcph's default
MEL_MEAN, MEL_STD, STEP_LIMIT = -4.0, 4.0, 100
CHAIN_KEYS = TRAIN_KEYS + ("pe_text_style_encoder", "duration_predictor")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs: the suite runs test
    files in parallel workers, and torch's default of one thread a core
    in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def chain_config():
    """``train_config`` with a narrower pitch/energy branch and mel style
    encoder and a 2-layer duration prosody encoder: the CPU's convs and
    matmuls at the default widths of those three set most of a step's
    time."""
    mc = train_config()
    mc.mel_style_encoder.max_channels = 64
    mc.pitch_energy_predictor.inter_dim = 64
    mc.duration_predictor.n_layer = 2
    return mc


def chain_params(mc_jax, seed: int):
    """(params of the chain's seven models and the SLM, the mel style
    encoder's batch stats), every leaf drawn from ``seed``; the F0 head is
    ``train_params``' (about 180 Hz, voiced)."""
    params, stats = train_params(mc_jax, seed=seed)
    shapes = _inference_shapes(mc_jax.model_dump_json())
    for i, key in enumerate(("pe_text_style_encoder", "duration_predictor")):
        params[key] = fill_params(shapes[key], seed + 50 + i)
    return params, stats


def zero_f0_head(params):
    """``params`` with the F0 head zero, kernel and bias.  The stages past
    acoustic synthesize from the predicted F0, and a voiced one is
    ill-posed on any implementation (``well_posed_prior_inputs``): off its
    grid the harmonic prior's phase integral parts in the last bits, and a
    voiced onset leaves STFT frame 0 real, its phase 0 or pi by the sign
    of a rounding.  An unvoiced prediction leaves the prior the shared
    noise, silent at the onset, so the tight tolerances hold; the voiced
    cases hold the synthesis at the looser ``VOICED_*`` limits."""
    pe = dict(params["pitch_energy_predictor"])
    pe["f0_proj"] = {k: jnp.zeros_like(v) for k, v in pe["f0_proj"].items()}
    return {**params, "pitch_energy_predictor": pe}


def class_weight() -> np.ndarray:
    return np.random.default_rng(5).uniform(0.5, 2.0, 16).astype(np.float32)


@contextlib.contextmanager
def jax_noise_fixed(noise: np.ndarray):
    """Dropout off, zero latent noise and the shared harmonic-prior noise
    at phase 0 inside the JAX package."""
    original = jgen.generate_pcph

    def shared_noise_pcph(f0, voiced, rng, **kwargs):
        kwargs.update(noise_amplitude=0.0, random_init_phase=False)
        return original(f0, voiced, rng, **kwargs) \
            + NOISE_AMPLITUDE * jnp.asarray(noise)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape,
                                                                      dtype))
        mp.setattr(jgen, "generate_pcph", shared_noise_pcph)
        yield


def jax_state(mc_jax, params, stats):
    variables = {k: {"params": params[k]} for k in CHAIN_KEYS}
    variables["pe_mel_style_encoder"]["batch_stats"] = stats
    return jax_train_state(variables, mc_jax)


def jax_setup(mc_jax, params, stats, batch):
    cfg = JaxConfig()
    cfg.training.mixed_precision = "no"
    state = jax_state(mc_jax, params, stats)
    ctx = JaxContext(models=jax_build_models(mc_jax), model_config=mc_jax,
                     config=cfg, mel_mean=MEL_MEAN, mel_std=MEL_STD,
                     step_limit=STEP_LIMIT,
                     duration_class_weight=jnp.asarray(class_weight()))
    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
              for k, v in batch.items()}
    return state, ctx, jbatch


def port_setup(mc, params, stats, slm=None):
    """The port's state of the chain's models carrying the flax weights,
    every dropout at 0, and its f32 stage context (with the frozen SLM of
    the flax params ``slm``, where given)."""
    built = build_training_models(mc)
    for key in CHAIN_KEYS:
        flat = flatten(params[key])
        if key == "pe_mel_style_encoder":
            flat.update(flatten(stats))
        built[key].load_state_dict(load_flax_params(key, flat, built[key]))
        for m in built[key].modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    state = build_train_state(mc, CHAIN_KEYS, device="cpu",
                              models={k: built[k] for k in CHAIN_KEYS})
    cfg = Config()
    cfg.training.mixed_precision = "no"
    if slm is not None:
        from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor

        module = SLMFeatureExtractor(n_layers=mc.slm.layers).eval()
        module.load_state_dict(load_flax_params("slm", flatten(slm), module))
        slm = module
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=MEL_MEAN,
                       mel_std=MEL_STD, step_limit=STEP_LIMIT, slm=slm,
                       duration_class_weight=torch.from_numpy(class_weight()))
    return state, ctx


def port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_hooks(noise):
    return dict(sample=False, pcph_noise=torch.from_numpy(noise),
                pcph_phase=torch.zeros(1, 1))


def chain_inputs():
    """The configs, weights, batch and prior noise of the chain tests."""
    mc_jax = chain_config()
    voiced, stats = chain_params(mc_jax, seed=7)
    params = zero_f0_head(voiced)
    batch, noise = acoustic_batch(mc_jax, seed=3, tokens=8, frames=16)
    return dict(mc_jax=mc_jax,
                mc=load_model_config_json(mc_jax.model_dump_json()),
                params=params, voiced_params=voiced, stats=stats,
                batch=batch, noise=noise)


def spectral_distance(audio, reference, n_fft: int = 512) -> float:
    """||S(audio) - S(reference)|| / ||S(reference)|| of the STFT
    magnitudes (Hann window, hop n_fft / 4): blind to the phase that a
    voiced prior leaves ill-posed."""
    def mag(a):
        x = torch.tensor(np.asarray(a, np.float32))
        return torch.stft(x.reshape(-1, x.shape[-1]), n_fft, n_fft // 4,
                          window=torch.hann_window(n_fft),
                          return_complex=True).abs()

    s, ref = mag(audio), mag(reference)
    return float((s - ref).norm() / ref.norm())


def model_states(state):
    """Copies of every model's parameters and buffers."""
    return {k: {n: t.clone() for n, t in m.state_dict().items()}
            for k, m in state.models.items()}

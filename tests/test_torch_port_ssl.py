"""The frozen feature nets and decoders of the experimental stages against
the JAX package, on the CPU in f32, on the same numpy-seeded weights and
inputs: Kaldi fbank, the SimAM-ResNet34 ASP speaker net, the SLM encoder
without its relative-position bias (HuBERT-base), ``AdaptiveHubert``,
``SpeakerEmbeddingModel`` with and without ``proj``, Vocos and its mel, and
Griffin-Lim on a shared initial phase; then ``init_ssl``/``init_vocos``
reading weight files written by the JAX package's writer.

Tolerance: 1e-4 x the largest |output| (``MODULE_REL``) plus 1e-5 unless a
case says otherwise; both sides compute in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models import ssl as P
from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
from stylish_tts_tpu_torch.models.vocos import vocos_mel
from stylish_tts_tpu_torch.models.wespeaker import SimAMResNet34ASP
from stylish_tts_tpu_torch.ops.fbank import kaldi_fbank
from stylish_tts_tpu_torch.ops.griffin_lim import mel_to_audio
from stylish_tts_tpu_torch.train.init import init_ssl, init_vocos
from test_torch_port_helpers import assert_close, flatten, param_shapes
from torch_port_experimental import (few_threads,  # noqa: F401
                                     SPEAKER_CHANNELS, experimental_config,
                                     port_module, seeded, small_nets,
                                     small_vocos)


def _wave(b, t, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((b, t))
            ).astype(np.float32)


def _run(flax_mod, params, *inputs, **kwargs):
    apply = functools.partial(flax_mod.apply, **kwargs)
    return np.asarray(jax.jit(apply)(
        {"params": params}, *[jnp.asarray(a) for a in inputs]))


def test_kaldi_fbank_matches_jax():
    from stylish_tts_tpu.ops.fbank import kaldi_fbank as jax_fbank

    wave = _wave(2, 8000, 0)
    want = np.asarray(jax.jit(jax_fbank)(jnp.asarray(wave)))
    got = kaldi_fbank(torch.from_numpy(wave))
    assert got.shape == (2, 1 + (8000 - 400) // 160, 80)
    assert_close(got, want, what="kaldi_fbank")
    raw = np.asarray(jax_fbank(jnp.asarray(wave), cmn=False))
    assert_close(kaldi_fbank(torch.from_numpy(wave), cmn=False), raw,
                 what="kaldi_fbank without CMN")


def test_simam_resnet34_asp_matches_jax():
    from stylish_tts_tpu.models.wespeaker import SimAMResNet34ASP as J

    feats = _wave(2, 40 * 80, 1, 1.0).reshape(2, 40, 80)
    jmod = J(m_channels=SPEAKER_CHANNELS)
    params = seeded(param_shapes(jmod, jnp.asarray(feats)), 3)
    want = _run(jmod, params, feats)
    port = port_module(SimAMResNet34ASP(SPEAKER_CHANNELS), params)
    with torch.no_grad():
        got = port(torch.from_numpy(feats))
    assert got.shape == (2, SimAMResNet34ASP.out_dim(SPEAKER_CHANNELS, 80))
    assert_close(got, want, what="SimAMResNet34ASP")


def test_slm_without_relative_bias_matches_jax():
    """The HuBERT-base encoder: ``rel_pos_bias=False`` has no bias table
    and no gate (``load_flax_params`` fills every tensor from the JAX
    tree and uses every key), and every hidden state matches."""
    from stylish_tts_tpu.models.slm import SLMFeatureExtractor as J

    wave = _wave(2, 3200, 2)
    jmod = J(n_layers=1, rel_pos_bias=False)
    params = seeded(param_shapes(jmod, jnp.asarray(wave)), 4)
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(wave))
    port = port_module(SLMFeatureExtractor(n_layers=1, rel_pos_bias=False),
                       params, "slm")
    assert not any("rel_attn_embed" in n or "gru_rel_pos" in n
                   for n in port.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(wave))
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, np.asarray(w), what=f"hidden state {i}")


def test_adaptive_hubert_matches_jax():
    mc_jax, _ = experimental_config()
    hub_p, _, (hubert, _) = small_nets(mc_jax)
    from stylish_tts_tpu.models.ssl import AdaptiveHubert as J

    jmod = J(model_sr=24000, hubert_sr=16000,
             proj_dim=mc_jax.hubert.hidden_dim, n_layers=1)
    wave = _wave(2, 4800, 5)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=2)(
        {"params": hub_p}, jnp.asarray(wave), 17))
    with torch.no_grad():
        got = hubert(torch.from_numpy(wave), 17)
    assert got.shape == (2, 17, mc_jax.hubert.hidden_dim)
    assert_close(got, want, what="AdaptiveHubert")


@pytest.mark.parametrize("hidden", [96, 640], ids=["proj", "natural"])
def test_speaker_embedding_matches_jax(hidden):
    """At a width other than the net's natural one (640 at 4 channels) a
    ``proj`` maps it there; at the natural width there is none."""
    from stylish_tts_tpu.models.ssl import SpeakerEmbeddingModel as J

    jmod = J(model_sr=24000, hidden_dim=hidden, m_channels=SPEAKER_CHANNELS)
    wave = _wave(2, 9600, 6)
    params = seeded(param_shapes(jmod, jnp.asarray(wave)), 7)
    assert ("proj" in params) == (hidden == 96)
    want = _run(jmod, params, wave)
    port = port_module(P.SpeakerEmbeddingModel(
        model_sr=24000, hidden_dim=hidden, m_channels=SPEAKER_CHANNELS),
        params)
    assert (port.proj is not None) == (hidden == 96)
    with torch.no_grad():
        got = port(torch.from_numpy(wave))
    assert got.shape == (2, hidden)
    if hidden == 96:
        assert_close(got, want, what="SpeakerEmbeddingModel proj")
        return
    # the natural output is [mu, sqrt(E[x^2] - mu^2)] of the attentive
    # pooling: where the attention's weighted variance is near 0 that
    # difference cancels to f32 rounding of E[x^2] on both sides (sqrt
    # then amplifies it), so the std half is compared squared, against
    # the scale of E[x^2]
    half = hidden // 2
    assert_close(got[:, :half], want[:, :half], what="pooled mean")
    mu = want[:, :half].astype(np.float64)
    var_port = got[:, half:].double().numpy() ** 2
    var_want = want[:, half:].astype(np.float64) ** 2
    assert_close(var_port, var_want, rel=0.0,
                 abs_=1e-4 * float(np.max(mu ** 2 + var_want)),
                 what="pooled variance")


def test_vocos_and_its_mel_match_jax():
    from stylish_tts_tpu.models.vocos import Vocos as J
    from stylish_tts_tpu.models.vocos import vocos_mel as jax_vocos_mel

    from torch_port_experimental import VOCOS_SMALL

    audio = _wave(2, 6000, 8)
    want_mel = np.asarray(jax.jit(jax_vocos_mel)(jnp.asarray(audio)))
    mel = vocos_mel(torch.from_numpy(audio))
    assert mel.shape == (2, 6000 // 256 + 1, 100)
    assert_close(mel, want_mel, what="vocos_mel")
    params, port = small_vocos()
    want = _run(J(**VOCOS_SMALL), params, want_mel)
    with torch.no_grad():
        got = port(mel)
    assert got.shape == (2, (mel.shape[1] - 1) * 256)
    assert_close(got, want, what="Vocos")


@pytest.mark.parametrize("power", [2.0, 1.0], ids=["model", "vocos"])
def test_griffin_lim_matches_jax(power):
    """Four Griffin-Lim iterations from the same initial phase (JAX's
    uniform draw patched): the waveforms agree within 1e-3 of their peak
    (the atan2 of near-silent bins parts in the last bits)."""
    from stylish_tts_tpu.ops import griffin_lim as J

    kw = (dict(n_fft=2048, win_length=1200, hop_length=300)
          if power == 2.0 else dict(n_fft=1024, win_length=1024,
                                    hop_length=256))
    rng = np.random.default_rng(9)
    mel = (0.5 * rng.standard_normal((2, 12, 80 if power == 2.0 else 100))
           ).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 12, kw["n_fft"] // 2 + 1)
                        ).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda *a, **k: jnp.asarray(phase))
        want = np.asarray(J.mel_to_audio(
            jnp.asarray(mel), sample_rate=24000, mean=-4.0, std=2.0,
            n_iter=4, power=power, **kw))
    got = mel_to_audio(torch.from_numpy(mel), sample_rate=24000, mean=-4.0,
                       std=2.0, n_iter=4, power=power,
                       phase=torch.from_numpy(phase), **kw)
    assert got.shape == (2, 12 * kw["hop_length"])
    assert_close(got, want, rel=1e-3, what=f"mel_to_audio power {power}")


def test_init_ssl_and_vocos_read_weight_files(tmp_path):
    """``hubert.weights_path`` fills the HuBERT encoder,
    ``speaker_embedder.weights_path`` the SimAM-ResNet34 and
    ``training.vocos_weights`` Vocos, each from a flat safetensors of the
    flax names written by the JAX package's writer; the rest of each net
    is drawn from the generator, and every net is frozen."""
    from stylish_tts_tpu.models.slm import SLMFeatureExtractor as JS
    from stylish_tts_tpu.models.vocos import Vocos as JV
    from stylish_tts_tpu.models.wespeaker import SimAMResNet34ASP as JW
    from stylish_tts_tpu.train.checkpoint import save_model_safetensors

    _, mc = experimental_config()
    trees = {
        "hubert": seeded(param_shapes(JS(n_layers=6, rel_pos_bias=False),
                                      jnp.zeros((1, 3200))), 11),
        "speaker": seeded(param_shapes(JW(), jnp.zeros((1, 40, 80))), 12),
        "vocos": seeded(param_shapes(JV(), jnp.zeros((1, 8, 100))), 13),
    }
    for name, tree in trees.items():
        save_model_safetensors(tmp_path / f"{name}.safetensors", tree)
    mc.hubert.weights_path = str(tmp_path / "hubert.safetensors")
    mc.speaker_embedder.weights_path = str(tmp_path / "speaker.safetensors")
    hubert, speaker = init_ssl(mc, torch.Generator().manual_seed(0))
    vocos = init_vocos(str(tmp_path / "vocos.safetensors"))
    assert init_vocos(None) is None
    for module, tree in ((hubert.encoder, trees["hubert"]),
                         (speaker.xvector, trees["speaker"]),
                         (vocos, trees["vocos"])):
        want = load_flax_params("file", flatten(tree), module)
        for key, t in module.state_dict().items():
            assert torch.equal(t, want[key]), key
    assert hubert.final_proj.weight.shape == (mc.hubert.hidden_dim, 768)
    assert speaker.proj.weight.shape == (mc.speaker_embedder.hidden_dim,
                                         10240)
    for module in (hubert, speaker, vocos):
        assert not module.training
        assert not any(p.requires_grad for p in module.parameters())

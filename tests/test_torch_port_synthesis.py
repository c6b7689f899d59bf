"""The port's synthesis slice end to end against the JAX package's graphs,
plus the port's own requests and its ``speak`` command, at the tiny config.

Both sides get the same harmonic-prior noise: the JAX ``generate_pcph`` is
wrapped to run noise-free with no random phase and then add the numpy noise,
and the port is handed the same noise.  With noise in every sample each STFT
bin of the prior sits far above f32 rounding, so its arctan2 phase is
well-conditioned on both sides.
"""

from __future__ import annotations

import functools
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import stylish_tts_tpu.models.generator as jgen
from stylish_tts_tpu.duration import DurationProcessor as JaxDurations
from stylish_tts_tpu.export.infer import frame_bucket as jax_frame_bucket
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.utils.synthetic import tiny_model_config
from stylish_tts_tpu_torch.config import load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.export.infer import (Synthesizer, frame_bucket,
                                                measure_rtf, to_pcm16)
from stylish_tts_tpu_torch.models import INFERENCE_MODELS, build_models
from test_torch_port_helpers import (_inference_params, assert_close,
                                     flatten, speech_level,
                                     well_posed_prior_inputs)

PHONEMES = ["ðɪs ɪz ə tˈɛst", "hˈɛloʊ wˈɜːld, haʊ ɑːɹ juː tədˈeɪ?"]
NOISE_AMPLITUDE = 0.01  # generate_pcph's default


@pytest.fixture(scope="module")
def setup():
    mc_jax = tiny_model_config()
    mc = load_model_config_json(mc_jax.model_dump_json())
    params = speech_level(_inference_params(mc_jax, seed=40))
    models = build_models(mc)
    for key in INFERENCE_MODELS:
        models[key].load_state_dict(
            load_flax_params(key, flatten(params[key]), models[key]))
    return mc_jax, mc, params, Synthesizer(mc, models, device="cpu")


def test_synthesis_path_matches_jax_graphs(setup, monkeypatch):
    mc_jax, mc, params, synth = setup
    jm = jax_build_models(mc_jax)

    def run(name, *args, **kwargs):
        """A JAX graph under jit (one compile beats eager flax's per-op
        compiles)."""
        apply = functools.partial(jm[name].apply, **kwargs)
        return jax.jit(apply)({"params": params[name]}, *args)

    tokens, lengths, counts = synth.encode_batch(PHONEMES)
    tok_j, len_j = jnp.asarray(tokens.numpy(), jnp.int32), \
        jnp.asarray(lengths.numpy(), jnp.int32)

    # duration graph -> durations
    logits = synth.duration_logits(tokens, lengths)
    logits_j = run("duration_predictor", tok_j, len_j)
    assert_close(logits, logits_j, what="duration logits")
    durs_j = np.asarray(JaxDurations().prediction_to_duration(logits_j))
    durs = synth.duration_processor.prediction_to_duration(logits).numpy()
    np.testing.assert_array_equal(durs, durs_j)
    dur_vec = np.zeros(tokens.shape, np.int64)
    for i, n in enumerate(counts):
        dur_vec[i, :n] = durs_j[i, :n]
    frames = max(frame_bucket(int(d.sum())) for d in dur_vec)
    assert frames == max(jax_frame_bucket(int(d.sum())) for d in dur_vec)

    # style graph
    style = synth.style_graph(tokens, lengths)
    pe_j, _, _ = run("pe_text_encoder", tok_j, len_j)
    style_j = run("pe_text_style_encoder", pe_j, len_j)
    assert_close(style, style_j, what="style")

    # pitch / energy graph
    alignment = JaxDurations().batched_duration_to_alignment(
        jnp.asarray(dur_vec, jnp.int32), frames)
    pitch_j, energy_j = run("pitch_energy_predictor", pe_j, len_j, alignment,
                            style_j)
    align_t = synth.duration_processor.batched_duration_to_alignment(
        torch.from_numpy(dur_vec), frames)
    np.testing.assert_array_equal(align_t.numpy(), np.asarray(alignment))
    pe_enc, _, _ = synth.models["pe_text_encoder"](tokens, lengths)
    with torch.no_grad():
        pitch, energy = synth.models["pitch_energy_predictor"](
            pe_enc, lengths, align_t, style)
    assert_close(pitch, pitch_j, what="pitch")
    assert_close(energy, energy_j, what="energy")

    # speech graph: the same prior noise, latent sampling off
    noise = np.random.default_rng(41).standard_normal(
        (len(PHONEMES), frames * mc.hop_length)).astype(np.float32)
    f0, noise = well_posed_prior_inputs(np.asarray(pitch_j), noise)
    original = jgen.generate_pcph

    def shared_noise_pcph(f0, voiced, rng, **kwargs):
        kwargs.update(noise_amplitude=0.0, random_init_phase=False)
        return original(f0, voiced, rng, **kwargs) \
            + NOISE_AMPLITUDE * jnp.asarray(noise)

    monkeypatch.setattr(jgen, "generate_pcph", shared_noise_pcph)
    pred_j = run("speech_predictor", tok_j, len_j, alignment,
                 jnp.asarray(f0), energy_j, None, sample=False,
                 rngs={"sample": jax.random.PRNGKey(0)})
    audio_j = np.asarray(pred_j.audio)
    pcm_j = np.asarray(jnp.clip(pred_j.audio * 32767.0, -32768.0, 32767.0)
                       .astype(jnp.int16))

    with torch.no_grad():
        audio = synth.models["speech_predictor"](
            tokens, lengths, align_t, torch.from_numpy(f0), energy,
            sample=False, pcph_noise=torch.from_numpy(noise),
            pcph_phase=torch.zeros(1, 1)).audio
    pcm = to_pcm16(audio).numpy()
    assert audio.shape == (len(PHONEMES), frames * mc.hop_length)
    # the whole slice, about sixty f32 layers deep and through exp(logamp)
    # and an iSTFT: within 1e-3 of full scale
    assert_close(audio, audio_j, rel=0.0, abs_=1e-3, what="audio")
    diff = np.abs(pcm.astype(np.int32) - pcm_j.astype(np.int32))
    assert diff.max() <= 33, f"PCM differs by {diff.max()} LSB"  # 1e-3 * 32767
    assert np.abs(audio_j).max() > 1e-2  # the comparison saw real signal


def test_synthesize_batch_with_sampling(setup):
    _, mc, _, synth = setup
    before = synth.generator.get_state().clone()
    out = synth.synthesize_batch(PHONEMES, fixed_duration=3)
    assert not torch.equal(before, synth.generator.get_state())  # sampled
    for phonemes, audio in zip(PHONEMES, out):
        n = len(synth.text_cleaner(phonemes)) + 2
        assert audio.shape == (n * 3 * mc.hop_length,)
        assert np.all(np.isfinite(audio)) and np.abs(audio).max() > 0
    single = synth.synthesize(PHONEMES[0])
    total = int(synth.predict_durations(PHONEMES[0]).sum())
    assert single.shape == (total * mc.hop_length,)
    assert np.all(np.isfinite(single))
    longform = synth.synthesize_longform(PHONEMES)
    assert longform.ndim == 1 and np.all(np.isfinite(longform))
    report = measure_rtf(synth, PHONEMES[0], iters=1)
    assert report.audio_seconds == single.shape[0] / mc.sample_rate
    assert report.rtf > 0


def test_speak_command_on_a_packaged_artifact(setup, tmp_path):
    from stylish_tts_tpu_torch import cli

    mc_jax, mc, params, _ = setup
    artifact = tmp_path / "artifact"
    artifact.mkdir()
    # written the way the JAX package's package_inference_artifact does
    for key in INFERENCE_MODELS:
        save_file(flatten(params[key]), str(artifact / f"{key}.safetensors"))
    (artifact / "model_config.json").write_text(mc_jax.model_dump_json())

    out = tmp_path / "out.wav"
    cli.main(["speak", "--artifact", str(artifact), "--phonemes",
              PHONEMES[1], "--out", str(out), "--device", "cpu"])
    with wave.open(str(out), "rb") as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == \
            (1, 2, mc.sample_rate)
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")

    # a fresh synthesizer over the same weights and seed gives the same audio
    models = build_models(mc)
    for key in INFERENCE_MODELS:
        models[key].load_state_dict(
            load_flax_params(key, flatten(params[key]), models[key]))
    audio = Synthesizer(mc, models, device="cpu").synthesize(PHONEMES[1])
    np.testing.assert_array_equal(
        pcm, (np.clip(audio, -1, 1) * 32767).astype("<i2"))

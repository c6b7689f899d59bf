"""Each module of the port's synthesis slice against its flax counterpart,
on the same numpy-seeded weights and inputs, on the CPU in f32.

Tolerance: ``MODULE_REL``·max|ref| + ``MODULE_ABS`` unless a case says
otherwise; both sides compute in f32 and differ only in summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.utils.synthetic import tiny_model_config
from stylish_tts_tpu_torch.config import load_model_config_json
from test_torch_port_helpers import (assert_close, load_port, seeded_params,
                                     well_posed_prior_inputs)

B, T, F_MEL = 2, 12, 10
LENGTHS = np.array([T, 7], np.int32)  # the second item is padded


def _mc():
    mc_jax = tiny_model_config()
    return mc_jax, load_model_config_json(mc_jax.model_dump_json())


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[
        ..., None]


def _alignment(lengths, t, frames, seed=0):
    """One-hot [B, T, frames]: each valid token owns >= 1 frame; frames past
    the total belong to no token."""
    rng = np.random.default_rng(seed)
    align = np.zeros((len(lengths), t, frames), np.float32)
    for b, n in enumerate(lengths):
        durs = 1 + rng.integers(0, 2, n)
        ends = np.minimum(np.cumsum(durs), frames)
        starts = ends - durs
        for i in range(n):
            align[b, i, max(starts[i], 0):ends[i]] = 1.0
    return align


def _pair(flax_mod, port_mod, inputs, *, seed=0, flax_kwargs=None,
          port_kwargs=None, rngs=None):
    """Same numpy-seeded params and inputs through flax and the port."""
    flax_kwargs, port_kwargs = flax_kwargs or {}, port_kwargs or {}
    jin = [jnp.asarray(a) for a in inputs]
    params = seeded_params(flax_mod, *jin, seed=seed, **flax_kwargs)
    # jit: one XLA compile beats eager flax's compile of every op
    apply = functools.partial(flax_mod.apply, rngs=rngs, **flax_kwargs)
    ref = jax.jit(apply)({"params": params}, *jin)
    load_port(port_mod, params)
    with torch.no_grad():
        out = port_mod(*[torch.from_numpy(np.asarray(a)) for a in inputs],
                       **port_kwargs)
    return jax.tree_util.tree_map(np.asarray, ref), out


# --------------------------------------------------------------------------- #
# models/norms.py, models/convnext.py


def case_channel_layer_norm():
    from stylish_tts_tpu.models import norms as J
    from stylish_tts_tpu_torch.models import norms as P

    ref, out = _pair(J.ChannelLayerNorm(), P.ChannelLayerNorm(24),
                     [_rand(B, T, 24, scale=3.0)])
    assert_close(out, ref)


def case_adaptive_norms():
    from stylish_tts_tpu.models import norms as J
    from stylish_tts_tpu_torch.models import norms as P

    x, s = _rand(B, T, 24, seed=1, scale=2.0), _rand(B, 16, seed=2)
    ref, out = _pair(J.AdaptiveLayerNorm(), P.AdaptiveLayerNorm(24, 16),
                     [x, s])
    assert_close(out, ref, what="AdaLN")
    ref, out = _pair(J.AdaptiveLayerNorm(eps=1e-6),
                     P.AdaptiveLayerNorm(24, 16, eps=1e-6), [x, s], seed=1)
    assert_close(out, ref, what="AdaLN eps 1e-6")
    ref, out = _pair(J.AdaptiveInstanceNorm(), P.AdaptiveInstanceNorm(24, 16),
                     [x, s], seed=2)
    assert_close(out, ref, what="AdaIN")


def case_conv1d():
    from stylish_tts_tpu.models import norms as J
    from stylish_tts_tpu_torch.models import norms as P

    x = _rand(B, T, 12, seed=3)
    for k, groups, out_dim in ((3, 1, 8), (7, 12, 12), (5, 4, 8), (31, 12,
                                                                   12)):
        ref, out = _pair(J.Conv1d(out_dim, k, groups=groups),
                         P.Conv1d(12, out_dim, k, groups=groups), [x], seed=k)
        assert_close(out, ref, what=f"conv k{k} g{groups}")


def case_adaptive_decoder_block():
    from stylish_tts_tpu.models import norms as J
    from stylish_tts_tpu_torch.models import norms as P

    s = _rand(B, 16, seed=4)
    for dim_in, dim_out in ((20, 24), (24, 24)):
        ref, out = _pair(J.AdaptiveDecoderBlock(dim_out),
                         P.AdaptiveDecoderBlock(dim_in, dim_out, 16),
                         [_rand(B, T, dim_in, seed=5), s])
        assert_close(out, ref, what=f"{dim_in}->{dim_out}")


def case_sequence_mask():
    from stylish_tts_tpu.models.norms import sequence_mask as jmask
    from stylish_tts_tpu_torch.models.norms import sequence_mask

    got = sequence_mask(torch.from_numpy(LENGTHS), T).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmask(jnp.asarray(LENGTHS),
                                                         T)))


def case_convnext():
    from stylish_tts_tpu.models import convnext as J
    from stylish_tts_tpu_torch.models import convnext as P

    x, s = _rand(B, T, 16, seed=6), _rand(B, 8, seed=7)
    ref, out = _pair(J.GRN(), P.GRN(16), [x])
    assert_close(out, ref, what="GRN")
    ref, out = _pair(J.BasicConvNeXtBlock(16, 64), P.BasicConvNeXtBlock(16, 64),
                     [x], seed=1)
    assert_close(out, ref, what="BasicConvNeXt")
    ref, out = _pair(J.StyleConvNeXtBlock(16, 48, kernel=15),
                     P.StyleConvNeXtBlock(16, 48, 8, kernel=15), [x, s],
                     seed=2)
    assert_close(out, ref, what="StyleConvNeXt")


# --------------------------------------------------------------------------- #
# models/text_encoder.py, style_encoders.py, prosody_encoder.py


def case_rope_and_attention():
    from stylish_tts_tpu.models import text_encoder as J
    from stylish_tts_tpu_torch.models import text_encoder as P

    q = _rand(B, 4, T, 20, seed=8)
    assert_close(P.apply_rope(torch.from_numpy(q), 10),
                 J.apply_rope(jnp.asarray(q), 10), what="rope")
    mask = _mask(LENGTHS, T)
    attn = P.pair_mask(torch.from_numpy(mask)).numpy()
    ref, out = _pair(J.MultiHeadAttention(40, 24, 4),
                     P.MultiHeadAttention(40, 24, 4),
                     [_rand(B, T, 40, seed=9), _rand(B, T, 40, seed=10),
                      attn])
    assert_close(out, ref, what="mha")


def case_text_encoder_parts():
    from stylish_tts_tpu.models import text_encoder as J
    from stylish_tts_tpu_torch.models import text_encoder as P

    mask = _mask(LENGTHS, T)
    x = _rand(B, T, 32, seed=11)
    ref, out = _pair(J.ConvFFN(32, 48, 3), P.ConvFFN(32, 32, 48, 3), [x, mask])
    assert_close(out, ref, what="ffn")
    ref, out = _pair(J.TransformerEncoder(32, 48, 4, 2, 3),
                     P.TransformerEncoder(32, 48, 4, 2, 3), [x, mask], seed=1)
    assert_close(out, ref, what="transformer")
    ref, out = _pair(J.ConvReluNorm(32, 32), P.ConvReluNorm(32, 32),
                     [x, mask], seed=2)
    assert_close(out, ref, what="prenet")


def case_text_encoder():
    from stylish_tts_tpu.models import text_encoder as J
    from stylish_tts_tpu_torch.models.duration_predictor import \
        text_encoder_for

    mc_jax, mc = _mc()
    tc = mc_jax.text_encoder
    tokens = np.random.default_rng(12).integers(1, tc.tokens, (B, T)) \
        .astype(np.int32)
    tokens[1, LENGTHS[1]:] = 0
    ref, out = _pair(
        J.TextEncoder(tc.tokens, tc.hidden_dim, tc.filter_channels, tc.heads,
                      tc.layers, tc.kernel_size, tc.dropout, mc.inter_dim),
        text_encoder_for(mc, mc.inter_dim), [tokens, LENGTHS])
    for name, a, b in zip(("mu", "hidden", "mask"), out, ref):
        assert_close(a, b, what=name)


def case_text_style_encoder():
    from stylish_tts_tpu.models.style_encoders import TextStyleEncoder as J
    from stylish_tts_tpu_torch.models.style_encoders import TextStyleEncoder

    ref, out = _pair(J(32, 2), TextStyleEncoder(48, 32, 2),
                     [_rand(B, T, 48, seed=13), LENGTHS])
    assert_close(out, ref)


def case_prosody_encoder():
    from stylish_tts_tpu.models.prosody_encoder import ProsodyEncoder as J
    from stylish_tts_tpu_torch.models.prosody_encoder import ProsodyEncoder

    ref, out = _pair(J(16, 32, 2), ProsodyEncoder(16, 32, 2),
                     [_rand(B, T, 32, seed=14), _rand(B, 16, seed=15),
                      LENGTHS])
    assert_close(out, ref)


# --------------------------------------------------------------------------- #
# duration predictor, duration.py, pitch/energy predictor, decoder


def case_duration_predictor():
    from stylish_tts_tpu.models.duration_predictor import DurationPredictor as J
    from stylish_tts_tpu_torch.models.duration_predictor import \
        DurationPredictor

    mc_jax, mc = _mc()
    tokens = np.random.default_rng(16).integers(1, 178, (B, T)).astype(
        np.int32)
    ref, out = _pair(J(mc_jax), DurationPredictor(mc), [tokens, LENGTHS])
    assert_close(out, ref)


def case_duration_processing():
    from stylish_tts_tpu.duration import DurationProcessor as J
    from stylish_tts_tpu_torch.duration import DurationProcessor

    logits = _rand(B, T, 16, seed=17, scale=3.0)
    # a row whose soft expectation is exactly 10.5: rounds half to even
    logits[0, 0] = -1e4
    logits[0, 0, [9, 10]] = 0.0  # classes of 15 and 18 frames -> 16.5
    logits[0, 1] = -1e4
    logits[0, 1, [7, 8]] = 0.0  # 9 and 12 frames -> 10.5 -> 10
    ref, port = J(), DurationProcessor()
    want = np.asarray(ref.prediction_to_duration(jnp.asarray(logits)))
    got = port.prediction_to_duration(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 16.0 and got[0, 1] == 10.0
    durs = np.random.default_rng(18).integers(0, 5, (B, T)).astype(np.int32)
    want = np.asarray(ref.batched_duration_to_alignment(jnp.asarray(durs), 40))
    got = port.batched_duration_to_alignment(torch.from_numpy(durs), 40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reference_band_mask", [False, True])
def test_pitch_energy_predictor(reference_band_mask):
    from stylish_tts_tpu.models import pitch_energy_predictor as J
    from stylish_tts_tpu_torch.models import pitch_energy_predictor as P

    mc_jax, _ = _mc()
    mc_jax.pitch_energy_predictor.reference_band_mask = reference_band_mask
    mc = load_model_config_json(mc_jax.model_dump_json())
    align = _alignment(LENGTHS, T, F_MEL * 2, seed=19)
    valid = np.arange(T)[None, :] < LENGTHS[:, None]
    allowed = P.build_monotonic_band_mask(
        torch.from_numpy(align), torch.from_numpy(valid), 2,
        reference_inverted=reference_band_mask).numpy()
    np.testing.assert_array_equal(allowed, np.asarray(
        J.build_monotonic_band_mask(jnp.asarray(align), jnp.asarray(valid), 2,
                                    reference_inverted=reference_band_mask)))
    pe = mc.pitch_energy_predictor.inter_dim
    ref, out = _pair(J.PitchEnergyPredictor(mc_jax),
                     P.PitchEnergyPredictor(mc),
                     [_rand(B, T, pe, seed=20), LENGTHS, align,
                      _rand(B, mc.style_dim, seed=21)])
    assert_close(out[0], ref[0], what="f0")
    assert_close(out[1], ref[1], what="energy")


def case_decoder():
    from stylish_tts_tpu.models.decoder import Decoder as J
    from stylish_tts_tpu_torch.models.decoder import Decoder

    ref, out = _pair(J(48, 16), Decoder(24, 48, 16, 8),
                     [_rand(B, F_MEL, 24, seed=22),
                      100 + 50 * _rand(B, F_MEL, seed=23),
                      _rand(B, F_MEL, seed=24), _rand(B, 8, seed=25)])
    assert_close(out, ref)


# --------------------------------------------------------------------------- #
# models/flow.py


def case_wavenet_and_coupling():
    from stylish_tts_tpu.models import flow as J
    from stylish_tts_tpu_torch.models import flow as P

    x, cond = _rand(B, T, 16, seed=26), _rand(B, 8, seed=27)
    ref, out = _pair(J.WaveNet(16, 5, 3, cond_channels=8),
                     P.WaveNet(16, 5, 3, cond_channels=8), [x],
                     flax_kwargs={"cond": jnp.asarray(cond)},
                     port_kwargs={"cond": torch.from_numpy(cond)})
    assert_close(out, ref, what="wavenet")
    triple = [_rand(B, T, 8, seed=s) for s in (28, 29, 30)]
    ref, out = _pair(
        J.ResidualCouplingBlock(8, 16, 5, 2, n_flows=3, cond_channels=8),
        P.ResidualCouplingBlock(8, 16, 5, 2, n_flows=3, cond_channels=8),
        triple + [cond], flax_kwargs={"reverse": True},
        port_kwargs={"reverse": True}, seed=31)
    for name, a, b in zip(("z", "mean", "logstd"), out, ref):
        assert_close(a, b, what=f"flow {name}")
    ref, out = _pair(J.PriorEncoder(8), P.PriorEncoder(16, 8), [x],
                     flax_kwargs={"sample": False},
                     port_kwargs={"sample": False})
    for name, a, b in zip(("z", "mean", "logstd"), out, ref):
        assert_close(a, b, what=f"prior {name}")


def case_upsample_x4():
    from stylish_tts_tpu.models.speech_predictor import upsample_x4_linear as J
    from stylish_tts_tpu_torch.models.speech_predictor import \
        upsample_x4_linear

    x = _rand(B, F_MEL, seed=32)
    got = upsample_x4_linear(torch.from_numpy(x))
    assert_close(got, J(jnp.asarray(x)), what="upsample")
    want = torch.nn.functional.interpolate(
        torch.from_numpy(x)[:, None], scale_factor=4, mode="linear",
        align_corners=False)[:, 0]
    assert_close(got, want.numpy(), what="vs torch Upsample")


# --------------------------------------------------------------------------- #
# models/generator.py


def case_generate_pcph():
    from stylish_tts_tpu.models.generator import generate_pcph as J
    from stylish_tts_tpu.models.speech_predictor import upsample_x4_linear
    from stylish_tts_tpu_torch.models.generator import generate_pcph

    rng = np.random.default_rng(33)
    noise = rng.standard_normal((B, 4 * F_MEL * 75)).astype(np.float32)
    # jit: both pitch cases share one compile (eager JAX compiles each op)
    upsample = jax.jit(upsample_x4_linear)
    pcph = jax.jit(functools.partial(
        J, hop_length=75, sample_rate=24000, noise_amplitude=0.0,
        random_init_phase=False))
    for name, pitch in (
        # on the exact grid: the phase integrals agree to the ulp
        ("exact", well_posed_prior_inputs(
            180 + 60 * _rand(B, F_MEL, seed=34), noise)[0]),
        # anywhere: the f32 cumsum of the phase rounds in another order
        ("any", np.where(_rand(B, F_MEL, seed=35) > -1.0,
                         180 + 60 * _rand(B, F_MEL, seed=36), 0.0)),
    ):
        pitch4 = np.array(upsample(jnp.asarray(pitch.astype(np.float32))))
        voiced = (pitch4 > 10.0).astype(np.float32)
        ref = np.asarray(pcph(jnp.asarray(pitch4), jnp.asarray(voiced),
                              jax.random.PRNGKey(0))) + 0.01 * noise
        got = generate_pcph(
            torch.from_numpy(pitch4), torch.from_numpy(voiced),
            hop_length=75, sample_rate=24000, noise=torch.from_numpy(noise),
            phase_offset=torch.zeros(1, 1))
        if name == "exact":
            # sin of equal f32 arguments, then a 16-term sum
            assert_close(got, ref, rel=0.0, abs_=1e-6, what="pcph exact")
        else:
            # a few f32 ulps of the largest phase integral, times 2π·h for
            # each of 16 harmonics of amplitude <= 0.1
            cum_max = float(np.sum(pitch4, axis=1).max()) * 75 / 24000
            bound = 8 * cum_max * 2.0**-23 * 2 * np.pi * 136 * 0.1
            assert_close(got, ref, rel=0.0, abs_=bound, what="pcph any")
    # the draws: standard-normal noise and one uniform offset in [0, 1)
    gen = torch.Generator().manual_seed(0)
    a = generate_pcph(torch.from_numpy(pitch4), torch.from_numpy(voiced),
                      hop_length=75, sample_rate=24000, generator=gen)
    assert a.shape == (B, pitch4.shape[1] * 75) and bool(a.isfinite().all())


def case_generator():
    from stylish_tts_tpu.models import generator as J
    from stylish_tts_tpu.models.speech_predictor import upsample_x4_linear
    from stylish_tts_tpu_torch.models.generator import Generator

    mc_jax, mc = _mc()
    rng = np.random.default_rng(37)
    noise = rng.standard_normal((B, 4 * F_MEL * 75)).astype(np.float32)
    pitch, noise = well_posed_prior_inputs(
        180 + 60 * _rand(B, F_MEL, seed=38), noise)
    pitch4 = np.array(upsample_x4_linear(jnp.asarray(pitch)))
    original = J.generate_pcph

    def shared_noise_pcph(f0, voiced, rng, **kwargs):
        kwargs.update(noise_amplitude=0.0, random_init_phase=False)
        return original(f0, voiced, rng, **kwargs) + 0.01 * jnp.asarray(noise)

    mel = _rand(B, 4 * F_MEL, mc.decoder.hidden_dim, seed=39)
    style = _rand(B, mc.style_dim, seed=40)
    inputs = [jnp.asarray(a) for a in (mel, style, pitch4,
                                       np.zeros_like(pitch4))]
    params = seeded_params(J.Generator(mc_jax), *inputs)
    J.generate_pcph = shared_noise_pcph
    try:
        ref = jax.jit(functools.partial(
            J.Generator(mc_jax).apply,
            rngs={"sample": jax.random.PRNGKey(0)}))({"params": params},
                                                    *inputs)
    finally:
        J.generate_pcph = original
    # the port's forward takes no energy: freegan does not use it
    port = load_port(Generator(mc), params)
    with torch.no_grad():
        out = port(torch.from_numpy(mel), torch.from_numpy(style),
                   torch.from_numpy(pitch4),
                   pcph_noise=torch.from_numpy(noise),
                   pcph_phase=torch.zeros(1, 1))
    assert_close(out.magnitude, ref.magnitude, what="log-amplitude")
    assert_close(out.phase, ref.phase, what="phase")
    assert_close(out.audio, ref.audio, what="audio")


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module(name):
    CASES[name]()

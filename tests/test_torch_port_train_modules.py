"""The training slice's modules, ops and losses of the port against their
JAX counterparts, in f32 on the CPU, on the same numpy inputs and weights.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.models import flow as jflow
from stylish_tts_tpu.models.discriminator import \
    MultiResolutionDiscriminator as JaxMRD
from stylish_tts_tpu.models.slm import SLMFeatureExtractor as JaxSLM
from stylish_tts_tpu.models.slm import slm_feature_loss as jax_slm_loss
from stylish_tts_tpu.models.style_encoders import MelStyleEncoder as JaxMSE
from stylish_tts_tpu.ops import mel as jmel
from stylish_tts_tpu.ops import stft as jstft
from stylish_tts_tpu.ops.multi_spectrogram import \
    MultiSpectrogram as JaxMultiSpec
from stylish_tts_tpu.ops.resample import resample as jax_resample
from stylish_tts_tpu_torch import losses as L
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models.discriminator import \
    MultiResolutionDiscriminator
from stylish_tts_tpu_torch.models.flow import (PosteriorEncoder,
                                               ResidualCouplingBlock)
from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor, \
    slm_feature_loss
from stylish_tts_tpu_torch.models.style_encoders import MelStyleEncoder
from stylish_tts_tpu_torch.ops import mel
from stylish_tts_tpu_torch.ops.multi_spectrogram import MultiSpectrogram
from stylish_tts_tpu_torch.ops.resample import resample
from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward
from test_torch_port_helpers import (assert_close, fill_params, flatten,
                                     load_port, param_shapes)

SR = 24000
RESOLUTIONS = [(512, 50, 240), (1024, 120, 600), (2048, 240, 1200)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _audio(seed=0, batch=2, samples=7200):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, samples))).astype(np.float32)


# --------------------------------------------------------------------------- #
# spectral ops


@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_stft_gradient_matches_jax_vjp(n_fft, hop, win):
    x = _audio(n_fft)
    rng = np.random.default_rng(n_fft + 1)
    frames = 1 + x.shape[1] // hop
    g = [rng.standard_normal((2, frames, n_fft // 2 + 1)).astype(np.float32)
         for _ in range(2)]
    fn = functools.partial(jstft.stft, n_fft=n_fft, hop_length=hop,
                           win_length=win)
    (want,) = jax.jit(lambda x, g: jax.vjp(fn, x)[1](g))(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in g))
    xt = _t(x).requires_grad_()
    real, imag = stft_forward(xt, n_fft=n_fft, hop_length=hop, win_length=win)
    ((real * _t(g[0])).sum() + (imag * _t(g[1])).sum()).backward()
    # f32 sums of up to n_fft / hop * 2F products in another order
    assert_close(xt.grad, want, rel=1e-5, what="d stft / dx")


def test_mel_frontend_matches_jax():
    x = _audio(1)
    kw = dict(n_mels=80, n_fft=2048, win_length=1200, hop_length=300,
              sample_rate=SR)
    to_mel_j, to_mel = jmel.MelSpectrogram(**kw), mel.MelSpectrogram(**kw)
    np.testing.assert_array_equal(
        mel.mel_filterbank(1025, 80, SR), jmel.mel_filterbank(1025, 80, SR))
    m_j, len_j = jax.jit(lambda a: jmel.calculate_mel(a, to_mel_j, -4.0,
                                                      4.0))(jnp.asarray(x))
    m, length = mel.calculate_mel(_t(x), to_mel, -4.0, 4.0)
    assert m.shape[1] % 2 == 0 and length.tolist() == np.asarray(len_j).tolist()
    assert_close(m, m_j, what="log mel")
    assert_close(mel.log_norm_energy(m, -4.0, 4.0),
                 jmel.log_norm_energy(m_j, -4.0, 4.0), what="energy")


def test_multi_spectrogram_matches_jax():
    target, pred = _audio(2), _audio(3)
    want = jax.jit(lambda t, p: JaxMultiSpec(SR)(target=t, pred=p))(
        jnp.asarray(target), jnp.asarray(pred))
    got = MultiSpectrogram(SR)(target=_t(target), pred=_t(pred))
    names = ["t_mag", "p_mag", "t_phase", "p_phase", "t_fft", "p_fft"]
    for name, gs, ws in zip(names, got, want):
        for i, (g, w) in enumerate(zip(gs, ws)):
            if "phase" in name:
                # voiced bins (|S| > 1e-3) of random audio have a phase set
                # by the signal; compare modulo 2 pi
                d = np.angle(np.exp(1j * (g.numpy() - np.asarray(w))))
                assert np.abs(d).max() <= 1e-3, (name, i)
            else:
                assert_close(g, w, what=f"{name}[{i}]")


def test_multi_spectrogram_phase_gradient_is_finite_in_silence():
    x = _audio(4)
    x[:, :3000] = 0.0  # |S| == 0: the masked arctan2 branch
    xt = _t(x).requires_grad_()
    _, _, _, p_phase, _, _ = MultiSpectrogram(SR)(target=_t(x), pred=xt)
    sum(p.sum() for p in p_phase).backward()
    assert torch.isfinite(xt.grad).all()


def test_resample_matches_jax():
    x = _audio(5, samples=7211)
    want = jax_resample(jnp.asarray(x), 24000, 16000)
    got = resample(_t(x), 24000, 16000)
    assert got.shape == want.shape == (2, 4808)
    assert_close(got, want, what="resample")


# --------------------------------------------------------------------------- #
# modules


def test_mel_style_encoder_and_its_spectral_norm_stats_match_jax():
    model = JaxMSE(style_dim=32, dim_in=80, max_conv_dim=384)
    mel_in = np.random.default_rng(6).standard_normal((2, 40, 80)) \
        .astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(mel_in)))
    params = fill_params(shapes["params"], seed=6)
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(
            rng.standard_normal(s.shape).astype(np.float32)
            if str(path[-1].key).endswith("/u") else np.ones(s.shape,
                                                               np.float32)),
        shapes["batch_stats"])
    out_j, new = jax.jit(functools.partial(
        model.apply, mutable=["batch_stats"], update_stats=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(mel_in))
    port = MelStyleEncoder(style_dim=32, dim_in=80, max_conv_dim=384)
    port.load_state_dict(load_flax_params(
        "pe_mel_style_encoder", {**flatten(params), **flatten(stats)}, port))
    with torch.no_grad():
        out = port(_t(mel_in), update_stats=True)
    assert_close(out, out_j, what="style")
    new_flat = flatten(new["batch_stats"])
    for name, buf in port.named_buffers():
        *path, leaf = name.split(".")
        key = "/".join(path) + f"/SpectralNorm_0/Conv_0/kernel/{leaf}"
        assert_close(buf, new_flat[key], what=name)


def test_posterior_encoder_matches_jax():
    hidden, flow_dim, cond = 32, 16, 8
    model = jflow.PosteriorEncoder(flow_dim, hidden, n_fft=2048,
                                   win_length=1200, hop_length=75,
                                   n_layers=3, cond_channels=cond)
    audio = _audio(8, samples=4800)
    audio[:, :1025] = 0.0  # frame 0 exactly zero: its phase is defined
    style = np.random.default_rng(9).standard_normal((2, cond)) \
        .astype(np.float32)
    params = fill_params(param_shapes(model, jnp.asarray(audio),
                                      jnp.asarray(style), sample=False),
                         seed=9)
    want = jax.jit(functools.partial(model.apply, sample=False))(
        {"params": params}, jnp.asarray(audio), jnp.asarray(style))
    port = load_port(PosteriorEncoder(flow_dim, hidden, 2048, 1200, 75,
                                      n_layers=3, cond_channels=cond), params)
    with torch.no_grad():
        got = port(_t(audio), _t(style), sample=False)
    for name, g, w in zip(("z", "mean", "logstd"), got, want):
        assert_close(g, w, what=name)


def test_flow_forward_direction_matches_jax():
    channels, cond = 16, 8
    model = jflow.ResidualCouplingBlock(channels, channels, n_flows=3,
                                        cond_channels=cond)
    rng = np.random.default_rng(10)
    z, mean, logstd = (rng.standard_normal((2, 30, channels))
                       .astype(np.float32) for _ in range(3))
    style = rng.standard_normal((2, cond)).astype(np.float32)
    args = tuple(map(jnp.asarray, (z, mean, logstd, style)))
    params = fill_params(param_shapes(model, *args), seed=10)
    port = load_port(ResidualCouplingBlock(channels, channels, n_flows=3,
                                           cond_channels=cond), params)
    for reverse in (False, True):
        want = jax.jit(functools.partial(model.apply, reverse=reverse))(
            {"params": params}, *args)
        with torch.no_grad():
            got = port(_t(z), _t(mean), _t(logstd), _t(style),
                       reverse=reverse)
        for name, g, w in zip(("z", "mean", "logstd"), got, want):
            assert_close(g, w, what=f"reverse={reverse} {name}")


def test_mrd_matches_jax():
    rng = np.random.default_rng(11)
    shapes = [(2, 257, 21, 1), (2, 513, 9, 1), (2, 1025, 5, 1)]
    t = [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]
    p = [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]
    model = JaxMRD()
    params = fill_params(param_shapes(model, t, t), seed=11)
    want = jax.jit(model.apply)({"params": params}, t, p)
    port = load_port(MultiResolutionDiscriminator(), params, "mrd")
    with torch.no_grad():
        got = port([_t(a) for a in t], [_t(a) for a in p])
    for kind in (0, 1):  # scores
        for g, w in zip(got[kind], want[kind]):
            assert_close(g, w, what="score")
    for kind in (2, 3):  # feature maps: the port's are channels-last too,
        for gs, ws in zip(got[kind], want[kind]):  # bar the [B, 1, F, T] head
            for g, w in zip(gs, ws):
                assert_close(g.reshape(w.shape), w, what="feature map")


def test_slm_matches_jax():
    model = JaxSLM(n_layers=2)
    audio = (0.1 * np.random.default_rng(12).standard_normal((2, 4000))) \
        .astype(np.float32)
    params = fill_params(param_shapes(model, jnp.asarray(audio)), seed=12)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(audio))
    port = load_port(SLMFeatureExtractor(n_layers=2), params, "slm")
    with torch.no_grad():
        got = port(_t(audio))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"hidden state {i}")
    other = [w + 0.1 for w in want]
    assert_close(slm_feature_loss(got, [_t(np.asarray(o)) for o in other]),
                 jax_slm_loss(want, other), what="slm loss")


# --------------------------------------------------------------------------- #
# losses


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def test_spectral_and_phase_losses_match_jax():
    a, b = _pair(13, (2, 30, 65))
    assert_close(L.spectral_convergence_loss(_t(a), _t(b)),
                 JL.spectral_convergence_loss(a, b), what="sc")
    assert_close(L.multi_resolution_stft_loss([_t(a), _t(b)], [_t(b), _t(a)]),
                 JL.multi_resolution_stft_loss([a, b], [b, a]), what="mrstft")
    a, b = 4 * a, 4 * b  # phases beyond +-pi: the wrapping is exercised
    assert_close(L.differential_phase_loss(_t(a), _t(b)),
                 JL.differential_phase_loss(a, b), what="phase")
    audio = _audio(14, samples=4800)
    mag, phase = _pair(15, (2, 65, 1025))
    kw = dict(n_fft=2048, hop_length=75, win_length=1200)
    got = L.magphase_loss(_t(mag), _t(phase), _t(audio), **kw)
    want = jax.jit(functools.partial(JL.magphase_loss, **kw))(
        mag, phase, jnp.asarray(audio))
    for g, w, what in zip(got, want, ("mag", "magphase phase")):
        # the target phase is 0 or +-pi where a bin is exactly real; the
        # anti-wrapped loss reads those the same
        assert_close(g, w, what=what)


def test_kl_losses_match_jax():
    rng = np.random.default_rng(16)
    z, m_q, logs_q, m_p, logs_p = (0.5 * rng.standard_normal((2, 12, 8))
                                   .astype(np.float32) for _ in range(5))
    assert_close(L.kl_loss(*map(_t, (z, logs_q, m_p, logs_p))),
                 JL.kl_loss(z, logs_q, m_p, logs_p), what="kl")
    assert_close(L.kl_loss_normal(*map(_t, (m_q, logs_q, m_p, logs_p))),
                 JL.kl_loss_normal(m_q, logs_q, m_p, logs_p), what="kl normal")
    stats = [tuple(0.5 * rng.standard_normal((2, 12, 8)).astype(np.float32)
                   for _ in range(3)) for _ in range(4)]
    names = ("text_stats", "text2mel_stats", "mel_stats", "mel2text_stats")
    want = JL.normalizing_flow_losses(SimpleNamespace(**dict(zip(
        names, stats))))
    got = L.normalizing_flow_losses(SimpleNamespace(**dict(zip(
        names, [tuple(map(_t, triple)) for triple in stats]))))
    assert set(got) == set(want) == {"kl_text", "kl_audio"}
    for key in want:
        assert_close(got[key], want[key], what=key)


def test_tprls_on_an_even_count_takes_the_mean_of_the_middles():
    # 6 values: torch.median would take the lower middle, jnp.median the mean
    real = np.array([[0.9, 0.1, 0.5], [0.3, 0.7, 0.2]], np.float32)
    gen = np.zeros_like(real)
    got = L._tprls(_t(real), _t(gen))
    assert_close(got, JL._tprls(real, gen), rel=0, abs_=1e-7, what="tprls")
    lower = torch.median(_t(real).reshape(-1))
    assert float(lower) != float(np.median(real))


def test_gan_losses_and_lr_multiplier_match_jax():
    rng = np.random.default_rng(17)
    rs = [rng.standard_normal((2, n)).astype(np.float32) for n in (40, 18)]
    gs = [rng.standard_normal((2, n)).astype(np.float32) for n in (40, 18)]
    rf = [[rng.standard_normal((2, 5, 6, 3)).astype(np.float32)] * 2] * 2
    gf = [[rng.standard_normal((2, 5, 6, 3)).astype(np.float32)] * 2] * 2
    tt = lambda xs: [_t(x) for x in xs]  # noqa: E731
    for g, w in zip(L.discriminator_loss(tt(rs), tt(gs)),
                    JL.discriminator_loss(rs, gs)):
        assert_close(g, w, what="discriminator")
    assert_close(
        L.generator_adversarial_loss(tt(rs), tt(gs), [tt(f) for f in rf],
                                     [tt(f) for f in gf]),
        JL.generator_adversarial_loss(rs, gs, rf, gf), what="generator")
    for ema in (0.5, 1.45, 1.5, 1.52, 1.6, 3.0):
        assert_close(L.disc_lr_multiplier(torch.tensor(ema)),
                     JL.disc_lr_multiplier(jnp.float32(ema)),
                     what=f"multiplier at {ema}")


def test_duration_and_smooth_l1_losses_match_jax():
    rng = np.random.default_rng(18)
    pred = rng.standard_normal((2, 7, 16)).astype(np.float32)
    target = rng.integers(0, 16, (2, 7))
    lengths = np.array([7, 4])
    weight = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    got = L.duration_loss(_t(pred), _t(target), _t(lengths), _t(weight))
    want = jax.jit(JL.duration_loss)(pred, target, lengths, weight)
    for g, w, what in zip(got, want, ("ce", "cdw")):
        assert_close(g, w, what=what)
    a, b = _pair(19, (3, 11))
    assert_close(L.smooth_l1_loss(_t(3 * a), _t(b)),
                 JL.smooth_l1_loss(3 * a, b), what="smooth l1")

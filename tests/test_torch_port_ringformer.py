"""The ringformer generator head of the port against the JAX package's, in
f32 on the CPU, on the same numpy inputs, weights and draws: snake and the
adaptive generator block, the conformer (flax's batch norm in train and
eval mode), the NSF source, the transposed convs, the head's forward and
its gradient, both ringformer speech predictors (text and hubert) and
their acoustic losses; the port's own acoustic and ``hubert_acoustic``
steps with the head; and the refusal to serve a ringformer voice, which
the JAX package cannot serve either.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.models.ringformer as jring
from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.config import RingformerGeneratorConfig as JaxRingCfg
from stylish_tts_tpu.models import conformer as jconf
from stylish_tts_tpu.models import norms as jnorms
from stylish_tts_tpu.models.hubert_speech_predictor import \
    HubertSpeechPredictor as JaxHubertSpeechPredictor
from stylish_tts_tpu.models.speech_predictor import \
    SpeechPredictor as JaxSpeechPredictor
from stylish_tts_tpu.ops.multi_spectrogram import \
    MultiSpectrogram as JaxMultiSpec
from stylish_tts_tpu.utils.synthetic import tiny_model_config
from stylish_tts_tpu_torch import losses as L
from stylish_tts_tpu_torch.config import load_model_config_json
from stylish_tts_tpu_torch.convert import load_flax_params
from stylish_tts_tpu_torch.models import conformer, ringformer
from stylish_tts_tpu_torch.models.hubert_speech_predictor import \
    HubertSpeechPredictor
from stylish_tts_tpu_torch.models.norms import (AdaptiveGeneratorBlock,
                                                Dropout, snake)
from stylish_tts_tpu_torch.models.speech_predictor import SpeechPredictor
from stylish_tts_tpu_torch.ops.multi_spectrogram import MultiSpectrogram
from test_torch_port_helpers import (acoustic_batch, assert_close,
                                     fill_params, flatten, param_shapes)
from torch_port_experimental import HUBERT_DIM, SPEAKER_DIM, small_nets

SR = 24000
STYLE = 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def ring_config():
    """(JAX, port) tiny configs with the ringformer head: decoder 64 wide,
    conformer depth 1, 64 initial channels (32 and 16 after the two
    upsamplings), two residual stacks a scale (kernels 3 and 7); the
    experimental tests' HuBERT and speaker widths."""
    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.text_encoder.dropout = 0.0
    mc.pitch_energy_predictor.dropout = 0.0
    mc.decoder.hidden_dim = 64
    mc.hubert.hidden_dim = HUBERT_DIM
    mc.speaker_embedder.hidden_dim = SPEAKER_DIM
    mc.generator = JaxRingCfg(upsample_initial_channel=64, depth=1,
                              resblock_kernel_sizes=[3, 7],
                              resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]])
    return mc, load_model_config_json(mc.model_dump_json())


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def seeded(shapes, seed):
    """``fill_params`` with every snake alpha at 1 + 0.1 N(0, 1): the
    default draw of a leaf (0.1 N) would put alphas near 0, where snake's
    1/alpha blows up."""
    params = fill_params(shapes, seed)
    rng = np.random.default_rng(seed + 1000)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (1.0 + 0.1 * jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32)))
        if str(path[-1].key).startswith("alpha") else v, params)


def random_stats(stats, seed):
    """Batch stats of ``stats``' shapes: means 0.1 N, variances in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(
            (0.1 * rng.standard_normal(v.shape)) if path[-1].key == "mean"
            else rng.uniform(0.5, 1.5, v.shape), jnp.float32), stats)


def load(module, params, stats=None):
    flat = flatten(params)
    flat.update(flatten(stats or {}))
    module.load_state_dict(load_flax_params("module", flat, module))
    return module


def source_draws(b, t, seed, harmonics=9):
    rng = np.random.default_rng(seed)
    return {"phase": rng.random((b, 1, harmonics)).astype(np.float32),
            "noise": rng.standard_normal((b, t, harmonics)).astype(
                np.float32),
            "noise_uv": rng.standard_normal((b, t, harmonics)).astype(
                np.float32)}


def jax_random_with(draws):
    """A stand-in for ``jax`` inside the JAX ringformer module whose
    ``random.uniform`` returns the shared phase and whose two
    ``random.normal`` calls of each trace return the shared noise, then
    the unvoiced noise."""
    normals = [draws["noise"], draws["noise_uv"]]
    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        calls.append(shape)
        return jnp.asarray(normals[(len(calls) - 1) % 2])

    random = SimpleNamespace(
        split=jax.random.split, fold_in=jax.random.fold_in,
        uniform=lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
            draws["phase"]),
        normal=normal)
    return SimpleNamespace(random=random, lax=jax.lax)


def voiced_pitch(b, frames, seed):
    """Frame-rate F0 on a 24000/512 Hz grid with an unvoiced first frame:
    the source is then exactly 0 under STFT frame 0 (whose phase would
    otherwise be 0 or ±π by the sign of a rounding), given draws that are
    0 there."""
    rng = np.random.default_rng(seed)
    step = SR / 512
    pitch = np.round(rng.uniform(100, 250, (b, frames)) / step) * step
    pitch[:, 0] = 0.0
    return pitch.astype(np.float32)


def quiet_onset(draws, params, samples=64):
    """Zero draws under STFT frame 0 and a zero ``merge`` bias: the source
    is then exactly 0 there, and so is the frame's phase on both sides."""
    merge = params["m_source"]["merge"] if "m_source" in params else \
        params["generator"]["m_source"]["merge"]
    merge["bias"] = jnp.zeros_like(merge["bias"])
    for key in ("noise", "noise_uv"):
        draws[key][:, :samples] = 0.0
    return draws


# --------------------------------------------------------------------------- #
# building blocks


def test_snake_and_adaptive_generator_block_match_jax():
    x, style = _normal(0, 2, 40, 16), _normal(1, 2, STYLE)
    alpha = 1.0 + 0.1 * _normal(2, 1, 1, 16)
    assert_close(snake(_t(x), _t(alpha)), jnorms.snake(x, alpha),
                 what="snake")
    jblock = jnorms.AdaptiveGeneratorBlock(16, kernel_size=5,
                                           dilation=(1, 3, 5))
    params = seeded(param_shapes(jblock, x, style), 3)
    want = jblock.apply({"params": params}, x, style)
    block = load(AdaptiveGeneratorBlock(16, STYLE, kernel_size=5), params)
    assert_close(block(_t(x), _t(style)), want, what="generator block")


def test_conformer_batch_norm_follows_flax_in_train_and_eval():
    x, style = _normal(4, 2, 30, 32), _normal(5, 2, STYLE)
    jmod = jconf.Conformer(dim=32, depth=2)
    variables = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x,
                                                 style))
    params = seeded(variables["params"], 6)
    stats = random_stats(variables["batch_stats"], 7)
    want, updated = jmod.apply({"params": params, "batch_stats": stats}, x,
                               style, train=True, mutable=["batch_stats"])
    port = load(conformer.Conformer(32, 2, STYLE), params, stats).train()
    assert_close(port(_t(x), _t(style)), want, what="conformer (train)")
    for name, value in flatten(updated["batch_stats"]).items():
        got = port.get_submodule(name.rsplit("/", 1)[0].replace("/", "."))
        assert_close(getattr(got, name.rsplit("/", 1)[1]), value,
                     rel=1e-5, what=f"running {name}")
    want_eval = jmod.apply({"params": params, **updated}, x, style)
    assert_close(port.eval()(_t(x), _t(style)), want_eval,
                 what="conformer (eval, updated stats)")


@pytest.mark.parametrize("rate,kernel", [(4, 8), (5, 10)])
def test_transposed_conv_places_samples_as_flax_same(rate, kernel):
    x = _normal(8, 2, 7, 12)
    jconv = flax.linen.ConvTranspose(6, (kernel,), strides=(rate,),
                                     padding="SAME")
    params = seeded(param_shapes(jconv, x), 9)
    want = jconv.apply({"params": params}, x)
    assert want.shape == (2, 7 * rate, 6)
    port = load(ringformer.ConvTranspose1d(12, 6, kernel, rate), params)
    assert_close(port(_t(x)), want, what="conv transpose")


def test_nsf_source_matches_jax_with_shared_draws(monkeypatch):
    b, t = 2, 1200
    f0 = np.repeat(voiced_pitch(b, 4, 10), 300, axis=1)
    draws = source_draws(b, t, 11)
    jsrc = jring.SourceModuleHnNSF(sample_rate=SR)
    params = seeded(param_shapes(jsrc, f0), 12)
    monkeypatch.setattr(jring, "jax", jax_random_with(draws))
    want = jsrc.apply({"params": params}, f0,
                      rngs={"sample": jax.random.PRNGKey(0)})
    port = load(ringformer.SourceModuleHnNSF(SR), params)
    got = port(_t(f0), draws={k: _t(v) for k, v in draws.items()})
    # the phase integral is an f32 cumsum over 1200 samples in another
    # order on each side; on the 24000/512 grid its partial sums are exact
    assert_close(got, want, what="source")
    assert_close(ringformer.upsample_linear(_t(f0[:, ::300]), 300),
                 jring.upsample_linear(jnp.asarray(f0[:, ::300]), 300),
                 what="upsample_linear")


# --------------------------------------------------------------------------- #
# the head and the speech predictor


def head_setup(seed=20, b=1, frames=6, voiced=False):
    """The head of both packages with the same weights, batch stats and
    draws.  Unvoiced by default: then the sines are masked out and the
    source is exact on both sides.  A voiced F0 is ill-posed on any pair of
    implementations: the phase integral is an f32 cumsum over the samples
    of the interpolated F0, summed in another order on each side, and the
    few ulps it differs by move the atan2 phase of the source's quiet
    bins by up to 4e-3."""
    mc_jax, mc = ring_config()
    hidden = mc.decoder.hidden_dim
    mel = _normal(seed, b, frames, hidden, scale=0.5)
    style = _normal(seed + 1, b, STYLE)
    pitch = voiced_pitch(b, frames, seed + 2) * voiced
    energy = np.zeros((b, frames), np.float32)
    jhead = jring.UpsampleGenerator(mc_jax)
    variables = jax.eval_shape(lambda: jhead.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        mel, style, pitch, energy))
    params = seeded(variables["params"], seed + 3)
    params["conv_post"]["kernel"] = 0.05 * params["conv_post"]["kernel"]
    stats = random_stats(variables["batch_stats"], seed + 4)
    draws = quiet_onset(source_draws(b, frames * 300, seed + 5), params)
    head = load(ringformer.UpsampleGenerator(mc), params, stats).eval()
    return SimpleNamespace(jhead=jhead, head=head, mel=mel, style=style,
                           pitch=pitch, energy=energy, params=params,
                           stats=stats, draws=draws)


def _head_outputs(s, mel=None):
    mel = _t(s.mel) if mel is None else mel
    return s.head(mel, _t(s.style), _t(s.pitch),
                  nsf_draws={k: _t(v) for k, v in s.draws.items()})


@pytest.fixture(scope="module")
def jax_head():
    """The JAX head's forward (audio, log-amplitude, phase) and its VJP
    for a cotangent on the audio, jitted once for ``head_setup``'s shapes,
    weights and draws; the F0 is an argument."""
    s = head_setup()
    rngs = {"sample": jax.random.PRNGKey(0)}

    def outputs(params, mel, pitch):
        pred = s.jhead.apply({"params": params, "batch_stats": s.stats},
                             mel, s.style, pitch, s.energy, rngs=rngs)
        return pred.audio, pred.magnitude, pred.phase

    def forward_and_vjp(params, mel, pitch, g):
        out, vjp = jax.vjp(lambda p, m: outputs(p, m, pitch), params, mel)
        return out, vjp((g, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jring, "jax", jax_random_with(s.draws))
        fn = jax.jit(forward_and_vjp)
        fn(s.params, jnp.asarray(s.mel), jnp.asarray(s.pitch),
           jnp.zeros((1, 6 * 300)))  # traced with the shared draws
    return fn


def test_upsample_generator_forward_and_gradient_match_jax(jax_head):
    s = head_setup()
    g = _normal(30, 1, 6 * 300)
    (audio, magnitude, phase), (d_params, d_mel) = jax_head(
        s.params, jnp.asarray(s.mel), jnp.asarray(s.pitch), jnp.asarray(g))
    want = SimpleNamespace(audio=audio, magnitude=magnitude, phase=phase)

    mel = _t(s.mel).requires_grad_()
    pred = _head_outputs(s, mel)
    assert pred.audio.shape == (1, 6 * 300)
    assert_close(pred.magnitude, want.magnitude, what="log-amplitude")
    assert_close(pred.phase, want.phase, what="phase")
    assert_close(pred.audio, want.audio, what="audio")
    (pred.audio * _t(g)).sum().backward()
    assert_close(mel.grad, d_mel, rel=1e-4, what="d audio / d mel")
    want_grads = load_flax_params("module", {**flatten(d_params),
                                             **flatten(s.stats)}, s.head)
    for name, p in s.head.named_parameters():
        if name.startswith("m_source."):
            # the silent onset puts atan2(0, 0) into the source's phase in
            # both packages: its gradient is NaN on both sides (a training
            # source always carries noise, so no frame is exactly silent)
            assert torch.isnan(p.grad).all()
            assert np.isnan(np.asarray(want_grads[name])).all()
            continue
        assert_close(p.grad, want_grads[name], rel=1e-4, abs_=1e-6,
                     what=f"d audio / d {name}")


def test_upsample_generator_voiced_forward_matches_jax(jax_head):
    """A voiced F0 (about 100-250 Hz from the second frame on): within the
    ill-posed phase integral's reach of the JAX head (measured 2.3e-4 of
    the largest log-amplitude, 3e-4 of the largest audio sample)."""
    s = head_setup(voiced=True)
    (audio, magnitude, phase), _ = jax_head(
        s.params, jnp.asarray(s.mel), jnp.asarray(s.pitch),
        jnp.zeros((1, 6 * 300)))
    want = SimpleNamespace(audio=audio, magnitude=magnitude, phase=phase)
    with torch.no_grad():
        pred = _head_outputs(s)
    for name in ("magnitude", "phase", "audio"):
        assert_close(getattr(pred, name), getattr(want, name), rel=2e-3,
                     what=f"voiced {name}")


def predictor_inputs(kind, mc, batch):
    """(JAX module, port module, positional inputs) of the ringformer
    speech predictor ``kind``: the text one on tokens and an alignment,
    the hubert one on unit-normal HuBERT features and a speaker vector."""
    energy = _normal(41, 2, 8, scale=0.3)
    if kind == "speech":
        args = [batch[k] for k in ("text", "text_length", "alignment",
                                   "pitch")]
        return (JaxSpeechPredictor(mc[0]), SpeechPredictor(mc[1],
                                                           posterior=True),
                args + [energy, batch["audio_gt"]])
    args = [_normal(45, 2, 8, HUBERT_DIM), np.array([8, 8], np.int32),
            _normal(46, 2, SPEAKER_DIM), batch["pitch"], energy,
            batch["audio_gt"]]
    return (JaxHubertSpeechPredictor(mc[0]), HubertSpeechPredictor(mc[1]),
            args)


@pytest.fixture(scope="module", params=["speech", "hubert"])
def predictor_case(request):
    """The ringformer speech predictor of both packages (``SpeechPredictor``
    or ``HubertSpeechPredictor``) with the same weights and batch stats,
    run in train mode with ``audio_gt`` (dropout off, latent means, shared
    source draws, an unvoiced F0)."""
    mc_jax, mc = ring_config()
    batch, _ = acoustic_batch(mc, seed=40, batch=2, tokens=8, frames=8)
    # unvoiced: the exact case of ``head_setup``
    batch["pitch"] = np.zeros_like(batch["pitch"])
    jmodel, port, inputs = predictor_inputs(request.param, (mc_jax, mc),
                                            batch)
    args = [jnp.asarray(a) for a in inputs]
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "sample": key, "dropout": key}, *args))
    params = seeded(variables["params"], 42)
    post = params["generator"]["conv_post"]
    post["kernel"] = 0.05 * post["kernel"]
    for head in [params["prior_encoder"], params["posterior_encoder"],
                 *params["flow"].values()]:
        for name in ("proj_mean", "proj_logstd"):
            head[name]["kernel"] = 0.1 * head[name]["kernel"]
    stats = random_stats(variables["batch_stats"], 43)
    draws = quiet_onset(source_draws(2, 8 * 300, 44), params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jring, "jax", jax_random_with(draws))
        want, updated = jax.jit(lambda p, s, *a: jmodel.apply(
            {"params": p, "batch_stats": s}, *a, train=True, sample=False,
            rngs={"sample": key, "dropout": key},
            mutable=["batch_stats"]))(params, stats, *args)
    load(port, params, stats).train()
    for m in port.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    pred = port(*[_t(np.asarray(a)) for a in args], sample=False,
                nsf_draws={k: _t(v) for k, v in draws.items()})
    return SimpleNamespace(want=want, updated=updated, pred=pred, port=port,
                           audio=batch["audio_gt"], mc=mc)


def test_ringformer_speech_predictor_matches_jax(predictor_case):
    c = predictor_case
    assert c.pred.audio.shape == (2, 8 * 300)
    for name in ("magnitude", "phase", "audio"):
        assert_close(getattr(c.pred, name), getattr(c.want, name),
                     rel=2e-4, what=name)
    for name in ("text_stats", "mel_stats", "mel2text_stats"):
        for i, (g, w) in enumerate(zip(getattr(c.pred, name),
                                       getattr(c.want, name))):
            assert_close(g, w, rel=2e-4, what=f"{name}[{i}]")
    for name, value in flatten(c.updated["batch_stats"]).items():
        owner, leaf = name.rsplit("/", 1)
        got = getattr(c.port.get_submodule(owner.replace("/", ".")), leaf)
        assert_close(got, value, rel=1e-5, what=f"running {name}")


def test_ringformer_acoustic_losses_match_jax(predictor_case):
    c = predictor_case
    gc = c.mc.generator
    grid = dict(n_fft=gc.gen_istft_n_fft, hop_length=gc.gen_istft_hop_size,
                win_length=gc.gen_istft_n_fft)
    want_mag, want_phase = JL.magphase_loss(
        c.want.magnitude, c.want.phase, jnp.asarray(c.audio), **grid)
    got_mag, got_phase = L.magphase_loss(c.pred.magnitude, c.pred.phase,
                                         _t(c.audio), **grid)
    jt, jp, *_ = jax.jit(lambda t, p: JaxMultiSpec(SR)(target=t, pred=p))(
        jnp.asarray(c.audio), c.want.audio)
    t_mag, p_mag, *_ = MultiSpectrogram(SR)(target=_t(c.audio),
                                            pred=c.pred.audio)
    for what, got, want in (
            ("mel", L.multi_resolution_stft_loss(t_mag, p_mag),
             JL.multi_resolution_stft_loss(jt, jp)),
            ("mag", got_mag, want_mag), ("phase", got_phase, want_phase)):
        assert math.isfinite(float(want)), what
        assert_close(got, want, rel=2e-4, what=what)


# --------------------------------------------------------------------------- #
# the port's own step, and serving


@pytest.mark.parametrize("stage_name", ["acoustic", "hubert_acoustic"])
def test_port_acoustic_step_with_ringformer_moves_weights_and_stats(
        stage_name):
    """One f32 step of the port's acoustic or ``hubert_acoustic`` stage
    with the ringformer head (the latter on the experimental tests' small
    frozen HuBERT and speaker nets): finite metrics, the head's weights
    and its conformer's running stats moved."""
    from stylish_tts_tpu_torch.config import Config
    from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)

    mc_jax, mc = ring_config()
    stage = STAGES[stage_name]
    state = build_train_state(mc, stage.models, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    cfg = Config()
    cfg.training.mixed_precision = "no"
    ssl = small_nets(mc_jax)[2] if stage_name == "hubert_acoustic" else None
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                       mel_std=4.0, step_limit=10,
                       slm=init_slm(mc, torch.Generator().manual_seed(1)),
                       ssl=ssl)
    batch, _ = acoustic_batch(mc, seed=50, batch=2, tokens=8, frames=8)
    batch = {k: _t(v) for k, v in batch.items()}
    sp = state.models[stage.train_models[0]]
    before = {k: v.clone() for k, v in sp.state_dict().items()}
    bn = sp.generator.conformer_0.block_0.conv.bn
    _, metrics = make_train_step(stage_name, ctx, 1e-4)(
        state, batch, torch.Generator().manual_seed(2))
    assert all(math.isfinite(float(v)) for v in metrics.values()), metrics
    assert {"mel", "mag", "phase", "generator", "discriminator"} <= set(
        metrics)
    after = sp.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.startswith("generator.up_0") for k in moved)
    assert not torch.equal(before["generator.conformer_0.block_0.conv.bn"
                                  ".mean"], bn.mean)
    assert not torch.equal(before["generator.conformer_0.block_0.conv.bn"
                                  ".var"], bn.var)


def test_neither_package_serves_a_ringformer_voice():
    """The JAX Synthesizer applies ``{"params": ...}`` only, so the
    conformers' batch norms find no ``batch_stats``; the port refuses the
    configuration when the Synthesizer is built."""
    from flax.errors import ScopeCollectionNotFound

    from stylish_tts_tpu.export.infer import Synthesizer as JaxSynthesizer
    from stylish_tts_tpu_torch.export.infer import Synthesizer
    from stylish_tts_tpu_torch.models import build_models
    from test_torch_port_helpers import _inference_params

    mc_jax, mc = ring_config()
    with pytest.raises(NotImplementedError, match="batch stats"):
        Synthesizer(mc, build_models(mc), device="cpu")
    synth = JaxSynthesizer(mc_jax, _inference_params(mc_jax))
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        synth.synthesize("abcdef", fixed_duration=2,
                         style=jnp.zeros((1, mc_jax.style_dim)))

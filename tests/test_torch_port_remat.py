"""``ModelConfig.remat_flow`` in the port: the flow's coupling layers and
the posterior encoder's WaveNet under activation checkpointing, against
the same modules without it (bit for bit) and against the JAX modules
with ``remat=True`` (at the flow parity tests' tolerances), in f32 on the
CPU at a tiny size.  No whole JAX train step is traced: the port's step
with the flag is held against the port's step without it.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.models import flow as jflow
from stylish_tts_tpu_torch.models import flow as pflow
from stylish_tts_tpu_torch.models.norms import Dropout
from stylish_tts_tpu_torch.train.stages import run_cast
from test_torch_port_helpers import (assert_close, fill_params, flatten,
                                     load_port, param_shapes)

CHANNELS, COND, FRAMES = 16, 8, 30
# the posterior encoder at the generator's hop (75) over 4800 samples
HIDDEN, FLOW_DIM, SAMPLES = 32, 16, 4800
# remat on against off: the same ops on the same inputs, so outputs are
# bit-equal; the gradients are the backward of the recomputed activations,
# which equal the kept ones bit for bit on the CPU (bound 1e-6 relative)
GRAD_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flow_inputs(seed=10):
    rng = np.random.default_rng(seed)
    z, mean, logstd = (rng.standard_normal((2, FRAMES, CHANNELS))
                       .astype(np.float32) for _ in range(3))
    style = rng.standard_normal((2, COND)).astype(np.float32)
    return z, mean, logstd, style


def _posterior_inputs(seed=8):
    rng = np.random.default_rng(seed)
    audio = (0.3 * rng.standard_normal((2, SAMPLES))).astype(np.float32)
    audio[:, :1025] = 0.0  # frame 0 exactly zero: its phase is defined
    style = rng.standard_normal((2, COND)).astype(np.float32)
    return audio, style


@pytest.fixture(scope="module")
def flow_pair():
    """JAX block with ``remat=True``, its params, and the port's block
    loaded from them (remat off; tests switch it)."""
    model = jflow.ResidualCouplingBlock(CHANNELS, CHANNELS, n_flows=3,
                                        cond_channels=COND, remat=True)
    args = tuple(map(jnp.asarray, _flow_inputs()))
    params = fill_params(param_shapes(model, *args), seed=10)
    port = load_port(pflow.ResidualCouplingBlock(
        CHANNELS, CHANNELS, n_flows=3, cond_channels=COND), params)
    return model, params, port


@pytest.fixture(scope="module")
def posterior_pair():
    model = jflow.PosteriorEncoder(FLOW_DIM, HIDDEN, n_fft=2048,
                                   win_length=1200, hop_length=75,
                                   n_layers=3, cond_channels=COND,
                                   remat=True)
    audio, style = map(jnp.asarray, _posterior_inputs())
    params = fill_params(param_shapes(model, audio, style, sample=False),
                         seed=9)
    port = load_port(pflow.PosteriorEncoder(FLOW_DIM, HIDDEN, 2048, 1200, 75,
                                            n_layers=3, cond_channels=COND),
                     params)
    return model, params, port


def _loss_weights(shapes, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _flow_loss(outs):
    """A linear loss that reaches every output element with its own
    weight: its gradient is set by the module alone, not by the size of
    its outputs."""
    weights = _loss_weights([tuple(o.shape) for o in outs])
    return sum((o * _t(w)).sum() for o, w in zip(outs, weights))


def _jax_loss(outs):
    weights = _loss_weights([tuple(o.shape) for o in outs])
    return sum(jnp.sum(o * w) for o, w in zip(outs, weights))


def _port_flow_run(port, remat: bool, reverse: bool, dtype=torch.float32):
    """Outputs and parameter gradients of the port's block, through
    ``run_cast`` (the step's bf16 copies) when ``dtype`` is bf16."""
    block = copy.deepcopy(port)
    block.remat = remat
    z, mean, logstd, style = map(_t, _flow_inputs())
    if dtype == torch.float32:
        outs = block(z, mean, logstd, style, reverse=reverse)
    else:
        outs = run_cast(block, dtype, z, mean, logstd, style,
                        reverse=reverse)
    _flow_loss(outs).backward()
    return ([o.detach() for o in outs],
            {n: p.grad for n, p in block.named_parameters()})


def _assert_grads_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        assert err <= GRAD_REL * float(g.abs().max()) + 1e-30, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_flow_remat_equals_plain(flow_pair, reverse, dtype):
    """Each coupling checkpointed, in both directions; in bf16 through
    ``run_cast``, whose parameter copies the recompute puts back."""
    _, _, port = flow_pair
    want_out, want_grads = _port_flow_run(port, False, reverse, dtype)
    got_out, got_grads = _port_flow_run(port, True, reverse, dtype)
    for g, w in zip(got_out, want_out):
        assert torch.equal(g, w)
    _assert_grads_equal(got_grads, want_grads)


def test_posterior_remat_equals_plain_and_keeps_one_stft(posterior_pair,
                                                         monkeypatch):
    """Only the WaveNet is checkpointed: the STFT runs once, forward and
    backward together."""
    _, _, port = posterior_pair
    calls = []
    real = pflow.stft_forward

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pflow, "stft_forward", counted)
    audio, style = map(_t, _posterior_inputs())
    runs = {}
    for remat in (False, True):
        enc = copy.deepcopy(port)
        enc.remat = remat
        calls.clear()
        outs = enc(audio.clone().requires_grad_(), style, sample=False)
        _flow_loss(outs).backward()
        runs[remat] = ([o.detach() for o in outs],
                       {n: p.grad for n, p in enc.named_parameters()},
                       len(calls))
    for g, w in zip(runs[True][0], runs[False][0]):
        assert torch.equal(g, w)
    _assert_grads_equal(runs[True][1], runs[False][1])
    assert runs[True][2] == runs[False][2] == 1


def test_remat_is_off_without_autograd(flow_pair, monkeypatch):
    """Synthesis (``no_grad``) never enters the checkpoint."""
    _, _, port = flow_pair
    block = copy.deepcopy(port)
    block.remat = True
    monkeypatch.setattr(pflow, "checkpoint", lambda *a, **k: pytest.fail(
        "checkpointed under no_grad"))
    with torch.no_grad():
        block(*map(_t, _flow_inputs()), reverse=True)


@pytest.mark.parametrize("reverse", [False, True])
def test_flow_remat_matches_jax(flow_pair, reverse):
    """Outputs and ``jax.grad`` of the JAX block with ``remat=True``
    against the port's with ``remat``."""
    model, params, port = flow_pair
    args = tuple(map(jnp.asarray, _flow_inputs()))

    def loss(p):
        outs = model.apply({"params": p}, *args, reverse=reverse)
        return _jax_loss(outs), outs

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    got, got_grads = _port_flow_run(port, True, reverse)
    for name, g, w in zip(("z", "mean", "logstd"), got, want):
        assert_close(g, w, what=f"reverse={reverse} {name}")
    _assert_grads_match_jax(port, got_grads, grads)


def _assert_grads_match_jax(port, got_grads: dict, jax_grads):
    """Each port gradient against the JAX gradient of the flax parameter
    it was loaded from (``load_flax_params``' mapping, run on the
    gradients)."""
    from stylish_tts_tpu_torch.convert import load_flax_params

    mapped = load_flax_params("module", flatten(jax_grads), port)
    assert set(mapped) == set(got_grads)
    for name, want in mapped.items():
        assert_close(got_grads[name], want, what=f"d/d {name}")


def test_posterior_remat_matches_jax(posterior_pair):
    model, params, port = posterior_pair
    audio, style = map(jnp.asarray, _posterior_inputs())

    def loss(p):
        outs = model.apply({"params": p}, audio, style, sample=False)
        return _jax_loss(outs), outs

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    enc = copy.deepcopy(port)
    enc.remat = True
    outs = enc(*map(_t, _posterior_inputs()), sample=False)
    _flow_loss(outs).backward()
    for name, g, w in zip(("z", "mean", "logstd"), outs, want):
        assert_close(g, w, what=name)
    _assert_grads_match_jax(
        port, {n: p.grad for n, p in enc.named_parameters()}, grads)


def test_the_checkpointed_regions_draw_nothing():
    """``torch.utils.checkpoint`` restores the global RNG streams, not the
    explicit generator the port's ``Dropout`` draws from, so a region that
    drew would recompute with another mask.  Both packages build these
    WaveNets with dropout 0; this pins it on the full-width model."""
    from stylish_tts_tpu_torch.config import ModelConfig
    from stylish_tts_tpu_torch.models.speech_predictor import SpeechPredictor

    mc = ModelConfig()
    mc.remat_flow = True
    model = SpeechPredictor(mc, posterior=True)
    assert model.flow.remat and model.posterior_encoder.remat
    regions = [getattr(model.flow, f"flow_{i}") for i in range(8)] + [
        model.posterior_encoder.enc]
    rates = [m.rate for r in regions for m in r.modules()
             if isinstance(m, Dropout)]
    assert len(rates) == 9 and set(rates) == {0.0}
    fields = {f.name: f.default for f in dataclasses.fields(jflow.WaveNet)}
    assert fields["dropout"] == 0.0


def test_a_drawing_region_would_recompute_another_mask(flow_pair):
    """Why the rate must stay 0: with dropout drawn from an explicit
    generator inside the checkpoint, the recompute draws a fresh mask and
    the gradients are no longer those of the forward."""
    _, _, port = flow_pair
    grads = {}
    for remat in (False, True):
        block = copy.deepcopy(port).train()
        block.remat = remat
        gen = torch.Generator().manual_seed(0)
        for m in block.modules():
            if isinstance(m, Dropout):
                m.rate, m.generator = 0.5, gen
        outs = block(*map(_t, _flow_inputs()))
        _flow_loss(outs).backward()
        grads[remat] = {n: p.grad for n, p in block.named_parameters()}
    assert any(not torch.allclose(grads[True][n], grads[False][n])
               for n in grads[False])


def test_acoustic_step_with_remat_flow_equals_without():
    """The port's acoustic train step at the tiny config in bf16 (the
    default mixed precision, through ``run_cast``) with ``remat_flow`` on
    and off from the same weights and batch: metrics and updated
    parameters bit-equal."""
    from stylish_tts_tpu_torch.config import Config
    from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)
    from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config
    from test_torch_port_helpers import acoustic_batch

    mc = tiny_model_config()
    mc.slm.layers = 1
    batch, noise = acoustic_batch(mc, seed=5, batch=2, tokens=8, frames=16)
    batch = {k: _t(v) for k, v in batch.items()}
    runs = {}
    for remat in (False, True):
        mc.remat_flow = remat
        state = build_train_state(
            mc, STAGES["acoustic"].models, device="cpu",
            generator=torch.Generator().manual_seed(0))
        ctx = StageContext(model_config=mc, config=Config(), mel_mean=-4.0,
                           mel_std=4.0, step_limit=100,
                           slm=init_slm(mc, torch.Generator().manual_seed(7)))
        for m in state.models["speech_predictor"].modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        assert state.models["speech_predictor"].flow.remat is remat
        _, metrics = make_train_step("acoustic", ctx, 1e-4)(
            state, batch, torch.Generator().manual_seed(3), sample=False,
            pcph_noise=_t(noise), pcph_phase=torch.zeros(1, 1))
        runs[remat] = ({k: float(v) for k, v in metrics.items()},
                       {n: p.detach().clone() for n, p in
                        state.models["speech_predictor"].named_parameters()})
    assert runs[True][0] == runs[False][0]
    for name, p in runs[False][1].items():
        assert torch.equal(runs[True][1][name], p), name

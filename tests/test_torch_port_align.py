"""The CTC aligner, its loss and Viterbi, the alignment stage, its loop
schedule and ``align`` on the CPU against the JAX package, and the CLI's
``train-align``, ``align`` and ``speak --text/--book``.

Weights are drawn from a numpy seed and loaded into both sides; dropout
is off on both (rate 0 in the port, ``flax.linen.Dropout`` patched out in
the JAX package while its steps trace).  Each JAX function is jitted once
in this file.
"""

from __future__ import annotations

import copy
import shutil
import wave
from dataclasses import asdict
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.data.batch_manager as jbm
import stylish_tts_tpu.train.loop as jloop
import stylish_tts_tpu_torch.data.batch_manager as pbm
import stylish_tts_tpu_torch.train.loop as ploop
from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.config import load_config_json as jax_config
from stylish_tts_tpu.config import \
    load_model_config_json as jax_model_config
from stylish_tts_tpu.dataprep.align_text import align_text as jax_align_text
from stylish_tts_tpu.models import build_models as jax_build_models
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.ops import ctc as jctc
from stylish_tts_tpu.train import stages as jstages
from stylish_tts_tpu.train.checkpoint import (
    load_model_safetensors as jax_load_model, save_model_safetensors as
    jax_save_model)
from stylish_tts_tpu.train.init import build_train_state as jax_train_state
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.convert import (export_flax_params,
                                           load_flax_params)
from stylish_tts_tpu_torch.dataprep.align_text import align_text
from stylish_tts_tpu_torch.models import INFERENCE_MODELS, build_models
from stylish_tts_tpu_torch.models.norms import Dropout
from stylish_tts_tpu_torch.models.text_aligner import (TextAligner,
                                                       aligner_params)
from stylish_tts_tpu_torch.ops import ctc as pctc
from stylish_tts_tpu_torch.ops.stft_kernel import stft_forward
from stylish_tts_tpu_torch.train import stages as pstages
from stylish_tts_tpu_torch.train.checkpoint import load_checkpoint
from stylish_tts_tpu_torch.train.init import build_train_state, init_params
from stylish_tts_tpu_torch.train.optim import BETAS
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   tiny_model_config)
from stylish_tts_tpu_torch.utils.tensorfile import (read_safetensors,
                                                    write_safetensors)
from test_torch_port_helpers import assert_close, flatten, seeded_params

# f32 on both sides, sums in another order: the aligner's and the step's
# outputs to a few ulps of their largest value, bounded well above that;
# the gradients of the CTC recursion (a softmax of path scores) likewise
REL, ABS = 1e-4, 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
# AdamW's first steps move each parameter by about lr * m / sqrt(v), the
# gradients' running mean over their RMS, so the update's error is about
# the gradient's over its RMS.  Where the RMS gradient is at least
# GRAD_FLOOR (1e3 x Adam's eps) the parameters agree within UPDATE_TOL (1%
# of a step; 0.24% measured).  A gradient below it is float noise (a bias
# ahead of a batch norm, the first conv's taps on mel bins that the test's
# tones leave constant): its sign may flip, so those parameters are within
# 2 lr a step, and they are at most LOOSE_SHARE of all (15.4% and 14.0%
# measured).  The first moments at the gradients' bounds.
LR = 1e-3
GRAD_FLOOR, UPDATE_TOL, LOOSE_SHARE = 1e-6, 1e-2 * LR, 0.2
# align_text: the boundary probabilities and the per-segment confidence,
# from log-probs that agree to REL
ALIGN_PROB_ABS, ALIGN_SCORE_REL = 1e-4, 1e-4
SR, HOP = 24000, 300


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def configs():
    mc = tiny_model_config()
    return mc, jax_model_config(dump_json(mc))


def seeded_stats(params, seed: int):
    """Running stats of the three batch norms: means near 0, variances
    around 1."""
    rng = np.random.default_rng(seed)
    width = params["tdnn_0"]["Conv_0"]["kernel"].shape[-1]
    return {f"bn_{i}": {
        "mean": jnp.asarray(0.1 * rng.standard_normal(width), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, width), jnp.float32)}
        for i in range(3)}


def port_aligner(mc, params, stats) -> TextAligner:
    module = TextAligner(80, mc.text_encoder.tokens,
                         mc.text_aligner.hidden_dim, dropout=0.0)
    flat = {**flatten(params), **flatten(stats)}
    module.load_state_dict(load_flax_params("text_aligner", flat, module))
    return module.eval()


def grads_flat(module: torch.nn.Module, values=None) -> dict:
    """The parameters' gradients (or ``values(p)``) under flat flax names
    and layouts."""
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for (_, p), (_, g) in zip(shadow.named_parameters(),
                                  module.named_parameters()):
            p.copy_(g.grad if values is None else values(g))
    return {k: v for k, v in export_flax_params("text_aligner", shadow)
            .items() if not k.endswith(("/mean", "/var"))}


@pytest.fixture(scope="module")
def aligner_case(configs):
    mc, mc_jax = configs
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 30, 80)).astype(np.float32)
    lengths = np.asarray([30, 22], np.int32)
    jmod = JaxAligner(n_mels=80, n_tokens=mc.text_encoder.tokens,
                      hidden_dim=mc.text_aligner.hidden_dim, dropout=0.0)
    params = seeded_params(jmod, jnp.asarray(mel), jnp.asarray(lengths),
                           seed=1)
    stats = seeded_stats(params, 2)
    targets = rng.integers(1, mc.text_encoder.tokens, (2, 9)).astype(np.int32)
    target_lengths = np.asarray([9, 6], np.int32)
    return dict(mel=mel, lengths=lengths, jmod=jmod, params=params,
                stats=stats, targets=targets, target_lengths=target_lengths)


# --------------------------------------------------------------------------- #
# the aligner


def test_aligner_eval_forward_matches_jax(configs, aligner_case):
    mc, _ = configs
    c = aligner_case
    want, _ = c["jmod"].apply({"params": c["params"], "batch_stats":
                               c["stats"]}, jnp.asarray(c["mel"]),
                              jnp.asarray(c["lengths"]))
    module = port_aligner(mc, c["params"], c["stats"])
    got, lengths = module(torch.from_numpy(c["mel"]),
                          torch.from_numpy(c["lengths"]))
    assert_close(got, np.asarray(want), rel=REL, abs_=ABS, what="log-probs")
    assert torch.equal(lengths, torch.from_numpy(c["lengths"]))
    assert set(module.state_dict()) >= {"bn_0.mean", "bn_2.var"}
    assert not any("num_batches" in k for k in module.state_dict())


def test_aligner_weights_cross_both_ways(configs, aligner_case):
    """flax params and batch stats -> the port -> flat flax names again,
    exactly; the params-only file's names are the flax params'."""
    mc, _ = configs
    c = aligner_case
    module = port_aligner(mc, c["params"], c["stats"])
    flat = {**flatten(c["params"]), **flatten(c["stats"])}
    back = export_flax_params("text_aligner", module)
    assert back.keys() == flat.keys()
    for name, value in flat.items():
        assert np.array_equal(back[name], value), name
    assert aligner_params(module).keys() == flatten(c["params"]).keys()
    drawn = init_params(TextAligner(80, mc.text_encoder.tokens,
                                    mc.text_aligner.hidden_dim),
                        torch.Generator().manual_seed(0))
    assert torch.equal(drawn.bn_1.mean, torch.zeros(64))
    assert torch.equal(drawn.bn_1.var, torch.ones(64))


def test_aligner_train_step_matches_jax(configs, aligner_case):
    """One train-mode forward and backward: log-probs, CTC loss, every
    gradient and the batch norms' running stats (flax's biased batch
    variance, momentum 0.9)."""
    mc, _ = configs
    c = aligner_case
    blank = mc.text_encoder.tokens

    def loss_fn(params, stats):
        (lp, _), upd = c["jmod"].apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(c["mel"]),
            jnp.asarray(c["lengths"]), train=True, mutable=["batch_stats"])
        loss = jctc.ctc_loss(lp, jnp.asarray(c["targets"]),
                             jnp.asarray(c["lengths"]),
                             jnp.asarray(c["target_lengths"]), blank)
        return loss, (lp, upd["batch_stats"])

    (loss, (lp, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(c["params"], c["stats"])
    module = port_aligner(mc, c["params"], c["stats"]).train()
    got_lp, _ = module(torch.from_numpy(c["mel"]),
                       torch.from_numpy(c["lengths"]))
    got = pctc.ctc_loss(got_lp, torch.from_numpy(c["targets"]),
                        torch.from_numpy(c["lengths"]),
                        torch.from_numpy(c["target_lengths"]), blank)
    got.backward()
    assert_close(got_lp, np.asarray(lp), rel=REL, abs_=ABS, what="log-probs")
    assert_close(got, np.asarray(loss), rel=REL, abs_=0, what="loss")
    want_grads = flatten(grads)
    got_grads = grads_flat(module)
    assert got_grads.keys() == want_grads.keys()
    for name, value in want_grads.items():
        assert_close(got_grads[name], value, rel=GRAD_REL, abs_=GRAD_ABS,
                     what=name)
    for name, value in flatten(new_stats).items():
        bn, leaf = name.split("/")
        assert_close(getattr(module, bn).__getattr__(leaf), value, rel=REL,
                     abs_=ABS, what=name)


# --------------------------------------------------------------------------- #
# CTC


def ctc_inputs(seed: int, ties: bool = False):
    """Non-normalised emissions [3, 20, 7] (or integer log-probs, where the
    Viterbi's predecessors tie), targets with a repeat, input lengths
    20/15/12 and target lengths 5/3/0, blank 6."""
    rng = np.random.default_rng(seed)
    b, t, c, l = 3, 20, 7, 5
    if ties:
        x = -rng.integers(0, 3, (b, t, c)).astype(np.float32)
    else:
        x = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
    targets = rng.integers(0, c - 1, (b, l)).astype(np.int32)
    targets[0, 1] = targets[0, 0]
    return dict(x=x, targets=targets,
                input_lengths=np.asarray([20, 15, 12], np.int32),
                target_lengths=np.asarray([5, 3, 0], np.int32), blank=c - 1,
                priors=(0.3 * rng.standard_normal(c)).astype(np.float32))


@pytest.mark.parametrize("priors", [False, True], ids=["plain", "priors"])
def test_ctc_loss_and_gradient_match_jax(priors):
    c = ctc_inputs(3)
    args = (c["targets"], c["input_lengths"], c["target_lengths"])

    def jax_loss(x):
        loss, prior_sum, frames = jctc.ctc_loss_with_priors(
            x, *map(jnp.asarray, args), c["blank"],
            log_priors=jnp.asarray(c["priors"]) if priors else None)
        return loss, (prior_sum, frames)

    (loss, (prior_sum, frames)), grad = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jnp.asarray(c["x"]))
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    # the stage passes zero priors until an epoch's end has set them
    got, got_sum, got_frames = pctc.ctc_loss_with_priors(
        x, *map(torch.from_numpy, args), c["blank"],
        torch.from_numpy(c["priors"] if priors
                         else np.zeros_like(c["priors"])))
    got.backward()
    assert_close(got, np.asarray(loss), rel=1e-5, abs_=0, what="loss")
    assert_close(x.grad, np.asarray(grad), rel=GRAD_REL, abs_=GRAD_ABS,
                 what="d loss / d emissions")
    assert_close(got_sum, np.asarray(prior_sum), rel=1e-5, abs_=1e-5,
                 what="prior sum")
    assert int(got_frames) == int(frames) == 47
    # each sequence's NLL, and their sum, before the mean over target
    # lengths
    lp = torch.log_softmax(torch.from_numpy(c["x"]), -1)
    nll = pctc._nll(lp, *map(torch.from_numpy, args), c["blank"])
    for reduction, value in (("none", nll), ("sum", nll.sum())):
        want = jctc.ctc_loss(jnp.asarray(lp.numpy()), *map(jnp.asarray, args),
                             c["blank"], reduction=reduction)
        assert_close(value, np.asarray(want), rel=1e-5, abs_=1e-5,
                     what=reduction)


# both cases' inputs share one shape and blank: one trace
_jax_forced_align = jax.jit(
    lambda *a: jctc.forced_align(*a, 6, return_states=True))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_forced_align_matches_jax_exactly(ties):
    c = ctc_inputs(4, ties=ties)
    lp = c["x"] if ties else np.asarray(
        torch.log_softmax(torch.from_numpy(c["x"]), -1))
    args = (lp, c["targets"], c["input_lengths"], c["target_lengths"])
    assert c["blank"] == 6
    want = _jax_forced_align(*map(jnp.asarray, args))
    got = pctc.forced_align(*map(torch.from_numpy, args), c["blank"],
                            return_states=True)
    for name, g, w in zip(("labels", "scores", "states"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    labels, scores = pctc.forced_align(*map(torch.from_numpy, args),
                                       c["blank"])
    assert torch.equal(labels, got[0]) and torch.equal(scores, got[1])
    # the path emits every target, in order, within the input length
    states = got[2].numpy()
    for i, (n, tl) in enumerate(zip(c["input_lengths"],
                                    c["target_lengths"])):
        assert np.all(np.diff(states[i, :n]) >= 0)
        emitted = sorted(set(s // 2 for s in states[i, :n] if s % 2))
        assert emitted == list(range(tl))


def test_update_log_priors_matches_jax():
    rng = np.random.default_rng(6)
    s = (rng.standard_normal(9) * 5).astype(np.float32)
    want = jctc.update_log_priors(jnp.asarray(s), jnp.log(jnp.float32(30.0)))
    got = pctc.update_log_priors(torch.from_numpy(s),
                                 torch.log(torch.tensor(30.0)))
    assert_close(got, np.asarray(want), rel=1e-6, abs_=1e-6)


# --------------------------------------------------------------------------- #
# the alignment stage


def stage_batch(mc, seed: int, frames: int = 40):
    rng = np.random.default_rng(seed)
    t = np.arange(frames * HOP) / SR
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(7 * t))
        + 0.01 * rng.standard_normal(t.shape) for f in (140.0, 210.0)])
    lengths = np.asarray([10, 7], np.int32)
    text = np.zeros((2, 12), np.int32)
    for i, n in enumerate(lengths):
        text[i, 1:n - 1] = rng.integers(1, mc.text_encoder.tokens, n - 2)
    return dict(audio_gt=audio.astype(np.float32), text=text,
                text_length=lengths)


@pytest.fixture(scope="module")
def stage_runs(configs, aligner_case):
    """Two f32 train steps of the alignment stage on both sides, the
    epoch's end between them (the second step's loss takes the priors),
    then the eval step."""
    mc, mc_jax = configs
    c = aligner_case
    batch = stage_batch(mc, 8)
    cfg = JaxConfig()
    cfg.training.mixed_precision = "no"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        jctx = jstages.StageContext(
            models=jax_build_models(mc_jax), model_config=mc_jax, config=cfg,
            mel_mean=-4.0, mel_std=4.0, step_limit=100)
        jstate = jax_train_state({"text_aligner": {
            "params": c["params"], "batch_stats": c["stats"]}}, mc_jax)
        step = jax.jit(jstages.make_train_step("alignment", jctx, LR))
        evaluate = jax.jit(jstages.make_eval_step("alignment", jctx))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jax_out = []
        for i in range(2):
            jstate, metrics = step(jstate, jb, jax.random.PRNGKey(i))
            jax_out.append((jax.device_get(metrics), jax.device_get(jstate)))
            if i == 0:
                jstate = jstages.end_alignment_epoch(jstate)
                jax_out.append(jax.device_get(jstate))
        jax_eval, _ = evaluate(jstate, jb, jax.random.PRNGKey(5))

    module = port_aligner(mc, c["params"], c["stats"])
    state = build_train_state(mc, ["text_aligner"], device="cpu",
                              models={"text_aligner": module})
    pcfg = Config()
    pcfg.training.mixed_precision = "no"
    ctx = pstages.StageContext(model_config=mc, config=pcfg, mel_mean=-4.0,
                               mel_std=4.0, step_limit=100)
    pstep = pstages.make_train_step("alignment", ctx, LR)
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    port_out = []
    opt = state.optimizers["text_aligner"]
    for i in range(2):
        state, metrics = pstep(state, pb, gen)
        module = state.models["text_aligner"]
        port_out.append((metrics, export_flax_params("text_aligner", module),
                         {k: v.clone() for k, v in state.priors.items()},
                         grads_flat(module,
                                    lambda p: opt.state[p]["exp_avg"])))
        if i == 0:
            pstages.end_alignment_epoch(state)
            port_out.append({k: v.clone() for k, v in state.priors.items()})
            # step 2 from the JAX package's weights and stats: a flipped
            # near-zero gradient of step 1 would carry its 2 lr into them
            js = jax_out[0][1]
            module.load_state_dict(load_flax_params("text_aligner", {
                **flatten(js.params["text_aligner"]),
                **flatten(js.batch_stats["text_aligner"])}, module))
    port_eval, audio = pstages.make_eval_step("alignment", ctx)(state, pb,
                                                                 gen)
    return jax_out, port_out, jax_eval, port_eval, audio


@pytest.mark.parametrize("i", [0, 2], ids=["flat_priors", "set_priors"])
def test_alignment_step_matches_jax(stage_runs, i):
    jax_out, port_out, _, _, _ = stage_runs
    (jm, js), (pm, params, priors, moments) = jax_out[i], port_out[i]
    assert set(pm) == set(jm) == {"align_loss", "loss"}
    for k in jm:
        assert_close(pm[k], np.asarray(jm[k]), rel=REL, abs_=0, what=k)
    want = flatten(js.params["text_aligner"])
    stats = flatten(js.batch_stats["text_aligner"])
    assert params.keys() == want.keys() | stats.keys()
    adam = js.opt_states["text_aligner"].inner_state[0]
    nu, t = flatten(adam.nu), i // 2 + 1
    loose = total = 0
    for name, value in want.items():
        err = np.abs(params[name] - np.asarray(value))
        rms_grad = np.sqrt(np.asarray(nu[name]) / (1 - BETAS[1] ** t))
        tight = rms_grad >= GRAD_FLOOR
        assert np.all(err[tight] <= UPDATE_TOL), (name, float(err.max()))
        assert np.all(err <= 2 * LR * (1 + 1e-3)), (name, float(err.max()))
        loose += int((~tight).sum())
        total += err.size
    assert loose <= LOOSE_SHARE * total, (loose, total)
    for name, value in stats.items():
        assert_close(params[name], value, rel=REL, abs_=ABS, what=name)
    mu = flatten(js.opt_states["text_aligner"].inner_state[0].mu)
    assert moments.keys() == mu.keys()
    for name, value in mu.items():
        assert_close(moments[name], value, rel=GRAD_REL, abs_=GRAD_ABS,
                     what=f"{name} first moment")
    assert_close(priors["prior_sum"], np.asarray(js.prior_sum), rel=REL,
                 abs_=ABS, what="prior_sum")
    assert float(priors["prior_frames"]) == float(js.prior_frames)
    assert bool(priors["priors_initialized"]) == bool(
        js.priors_initialized) == (i == 2)


def test_end_alignment_epoch_matches_jax(stage_runs):
    jax_out, port_out, _, _, _ = stage_runs
    js, priors = jax_out[1], port_out[1]
    assert_close(priors["log_priors"], np.asarray(js.log_priors), rel=REL,
                 abs_=ABS, what="log_priors")
    assert float(priors["log_priors"].min()) >= -12.0
    assert bool(priors["priors_initialized"])
    assert float(priors["prior_frames"]) == float(js.prior_frames) == 0.0
    assert torch.all(priors["prior_sum"] == -1e30)


def test_alignment_eval_step_matches_jax(stage_runs):
    _, _, jax_eval, port_eval, audio = stage_runs
    assert audio is None
    assert set(port_eval) == set(jax_eval) == {"align_loss", "confidence",
                                              "loss"}
    for k, v in jax_eval.items():
        assert_close(port_eval[k], np.asarray(v), rel=REL, abs_=ABS, what=k)
    assert 0.0 < float(port_eval["confidence"]) <= 1.0


def test_alignment_stage_trains_in_f32_under_bf16(configs, aligner_case):
    mc, _ = configs
    assert "text_aligner" in pstages.MIXED_PRECISION_EXEMPT
    state = build_train_state(mc, ["text_aligner"], device="cpu",
                              models={"text_aligner": port_aligner(
                                  mc, aligner_case["params"],
                                  aligner_case["stats"])})
    ctx = pstages.StageContext(model_config=mc, config=Config(),
                               mel_mean=-4.0, mel_std=4.0, step_limit=10)
    assert ctx.compute_dtype == torch.bfloat16
    batch = {k: torch.from_numpy(v) for k, v in stage_batch(mc, 9).items()}
    _, metrics = pstages.make_train_step("alignment", ctx, LR)(
        state, batch, torch.Generator().manual_seed(0))
    assert metrics["align_loss"].dtype == torch.float32
    assert torch.isfinite(metrics["align_loss"])


# --------------------------------------------------------------------------- #
# the loop's alignment schedule against the JAX loop


class _JaxState:
    params = {"text_aligner": None}

    def __init__(self, step=0):
        self.step = jnp.asarray(step, jnp.int32)

    def replace(self, **kwargs):
        return _JaxState(kwargs.get("step", self.step))


class _PortState:
    def __init__(self):
        self.models = {"text_aligner": None}
        self.optimizers, self.step = {}, 0
        self.disc_ema = {"mrd": torch.tensor(1.5)}


def _loop_config(root) -> Config:
    cfg = Config()
    cfg.dataset.path = str(root)
    cfg.training_plan.alignment.epochs = 3
    cfg.training_plan.alignment.probe_batch_max = 2
    cfg.training.log_interval = 2
    cfg.training.val_interval = 3
    cfg.training.save_interval = 4
    cfg.training.aot_memory_plan = False
    return cfg


def _recording(record, kind):
    def make_train_step(stage, ctx, lr):
        def step(state, batch, *rest):
            s = int(state.step)
            record.append(("train", stage, s, ctx.step_limit, lr,
                           np.asarray(batch["text"]).tolist()))
            if kind == "jax":
                return state.replace(step=state.step + 1), {
                    "loss": jnp.asarray(float(s))}
            state.step += 1
            return state, {"loss": torch.tensor(float(s))}
        return step

    def make_eval_step(stage, ctx):
        def step(state, batch, *rest):
            record.append(("eval", stage, int(state.step),
                           np.asarray(batch["text"]).tolist()))
            value = 10.0 - int(state.step)
            return {"loss": jnp.asarray(value) if kind == "jax"
                    else torch.tensor(value)}, None
        return step

    def end_epoch(state, *rest):
        record.append(("epoch_end", int(state.step)))
        return state

    def save(out_dir, name, state, manifest, *a, **k):
        record.append(("save", name, asdict(manifest)))

    def aligner_file(path, *rest):
        record.append(("aligner", Path(path).name))

    return make_train_step, make_eval_step, end_epoch, save, aligner_file


def _epochs(mp, cls, record):
    original = cls.epoch_iterator

    def epoch_iterator(self, **kwargs):
        record.append(("epoch", kwargs["stage"], kwargs["epoch"],
                       kwargs.get("skip_batches", 0),
                       kwargs.get("shuffle", True)))
        return original(self, **kwargs)

    mp.setattr(cls, "epoch_iterator", epoch_iterator)


def _run_jax(cfg, mc, out, max_steps):
    record = []
    train, evaluate, end_epoch, save, aligner_file = _recording(record,
                                                                "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "make_train_step", train)
        mp.setattr(jloop, "make_eval_step", evaluate)
        mp.setattr(jloop, "end_alignment_epoch", end_epoch)
        mp.setattr(jloop, "save_model_safetensors", aligner_file)
        mp.setattr(jloop, "make_parallel_train_step", lambda f, mesh: f)
        mp.setattr(jloop, "make_parallel_eval_step", lambda f, mesh: f)
        single = jloop.make_mesh
        mp.setattr(jloop, "make_mesh", lambda: single(1))
        mp.setattr(jloop, "replicate", lambda tree, mesh: tree)
        mp.setattr(jloop, "restrict_state", lambda state, keys: state)
        mp.setattr(jloop, "merge_state", lambda full, state: state)
        mp.setattr(jloop, "init_model_variables", lambda *a: {})
        mp.setattr(jloop, "build_train_state", lambda *a: _JaxState())
        mp.setattr(jloop, "init_slm_params", lambda *a: None)
        mp.setattr(jloop, "save_checkpoint", save)
        _epochs(mp, jbm.BatchManager, record)
        manifest = jloop.train_model(
            config=jax_config(dump_json(cfg)),
            model_config=jax_model_config(dump_json(mc)), out_dir=str(out),
            stage_name="alignment", max_steps=max_steps, workers=2)
    return record, asdict(manifest)


def _run_port(cfg, mc, out, max_steps):
    record = []
    train, evaluate, end_epoch, save, aligner_file = _recording(record,
                                                                "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "make_train_step", train)
        mp.setattr(ploop, "make_eval_step", evaluate)
        mp.setattr(ploop, "end_alignment_epoch", end_epoch)
        mp.setattr(ploop, "write_safetensors", aligner_file)
        mp.setattr(ploop, "aligner_params", lambda module: {})
        mp.setattr(ploop, "build_train_state", lambda *a, **k: _PortState())
        mp.setattr(ploop, "snapshot_state", lambda *a: None)
        mp.setattr(ploop, "save_checkpoint", save)
        _epochs(mp, pbm.BatchManager, record)
        manifest = ploop.train_model(
            config=cfg, model_config=mc, out_dir=str(out),
            stage_name="alignment", max_steps=max_steps, workers=2,
            device="cpu")
    return record, asdict(manifest)


@pytest.fixture(scope="module")
def loop_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("align_loop_data")
    make_synthetic_dataset(root, n_segments=12)
    return root


@pytest.mark.parametrize("max_steps", [None, 4], ids=["stage", "max_steps"])
def test_alignment_schedule_matches_jax(loop_data, tmp_path, max_steps):
    """Val-set training at each validation interval, the priors' update at
    each epoch's end (also after a max-steps stop), the aligner's file at
    the stage's end, and no next stage."""
    cfg, mc = _loop_config(loop_data), tiny_model_config()
    jax_record, jax_manifest = _run_jax(cfg, mc, tmp_path / "jax", max_steps)
    port_record, port_manifest = _run_port(cfg, mc, tmp_path / "port",
                                           max_steps)
    kinds = [r[0] for r in port_record]
    assert kinds.count("epoch_end") == (3 if max_steps is None else 2)
    assert ("aligner", "alignment_model.safetensors") in port_record
    assert kinds.count("train") > kinds.count("epoch_end") + 1
    assert port_record == jax_record
    assert port_manifest == jax_manifest


# --------------------------------------------------------------------------- #
# resume, and the aligner's file


def _final_state(out, mc):
    state = build_train_state(mc, ["text_aligner"], device="cpu",
                              generator=torch.Generator().manual_seed(99))
    gen = torch.Generator()
    _, manifest, _, meta = load_checkpoint(
        out / "alignment" / "checkpoint_final", state, gen)
    return state, gen.get_state(), asdict(manifest), meta


@pytest.fixture(scope="module")
def resumed(loop_data, tmp_path_factory):
    """Steps 1-2 straight (run A); step 1, stopped, then resumed from the
    checkpoint to step 2 (run B).  One step an epoch (the 10 train
    segments in one batch), the val set trained on and validated at step
    2, the priors set at each epoch's end."""
    mc = tiny_model_config()
    out = tmp_path_factory.mktemp("align_resume")
    cfg = _loop_config(loop_data)
    cfg.training_plan.alignment.epochs = 2
    cfg.training.log_interval = 1
    cfg.training.val_interval = 2
    cfg.training.save_interval = 100
    for name in ("a", "b"):
        (out / name / "alignment").mkdir(parents=True)
        (out / name / "alignment" / "alignment_batch_sizes.json").write_text(
            '{"0": 10}')
    run = dict(config=cfg, model_config=mc, stage_name="alignment",
               workers=2, device="cpu")
    ploop.train_model(out_dir=str(out / "a"), max_steps=2, **run)
    ploop.train_model(out_dir=str(out / "b"), max_steps=1, **run)
    stopped = _final_state(out / "b", mc)
    ploop.train_model(out_dir=str(out / "b"), max_steps=2,
                      checkpoint=str(out / "b" / "alignment"
                                     / "checkpoint_final"), **run)
    return {name: _final_state(out / name, mc) for name in ("a", "b")}, \
        stopped, out


def test_alignment_resume_equals_the_uninterrupted_run(resumed):
    runs, stopped, _ = resumed
    (a, gen_a, man_a, meta_a), (b, gen_b, man_b, meta_b) = runs["a"], \
        runs["b"]
    assert stopped[2]["current_step"] == 1 and man_a["current_step"] == 2
    assert man_a == man_b and man_a["stage"] == "alignment"
    assert meta_a["train_state"] == meta_b["train_state"]
    assert torch.equal(gen_a, gen_b)
    assert bool(stopped[0].priors["priors_initialized"])
    for key, value in a.priors.items():
        assert torch.equal(value, b.priors[key]), key
    assert not torch.equal(a.priors["log_priors"],
                           stopped[0].priors["log_priors"])
    sa, sb = a.models["text_aligner"].state_dict(), \
        b.models["text_aligner"].state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    moved = stopped[0].models["text_aligner"].state_dict()
    assert any(not torch.equal(v, sa[n]) for n, v in moved.items())
    oa, ob = a.optimizers["text_aligner"].state_dict(), \
        b.optimizers["text_aligner"].state_dict()
    for i, entry in oa["state"].items():
        for name, value in entry.items():
            assert torch.equal(value, ob["state"][i][name]), (i, name)


def test_aligner_file_is_params_only_and_jax_reads_it(resumed, configs):
    runs, _, out = resumed
    _, mc_jax = configs
    path = out / "a" / "alignment_model.safetensors"
    flat = read_safetensors(path)
    module = runs["a"][0].models["text_aligner"]
    assert flat.keys() == aligner_params(module).keys()
    assert not any(k.endswith(("/mean", "/var")) for k in flat)
    template = JaxAligner(n_mels=80, n_tokens=mc_jax.text_encoder.tokens,
                          hidden_dim=mc_jax.text_aligner.hidden_dim).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 80)),
        jnp.asarray([16]))["params"]
    loaded = jax_load_model(path, template)
    for name, value in flatten(loaded).items():
        assert np.array_equal(value, flat[name]), name


# --------------------------------------------------------------------------- #
# align


@pytest.fixture(scope="module")
def aligned(configs, aligner_case, tmp_path_factory):
    """align_text of one dataset by both packages, from one aligner file
    written by the JAX package's ``save_model_safetensors``."""
    mc, mc_jax = configs
    root = tmp_path_factory.mktemp("align_text")
    out = {}
    for pkg in ("jax", "port"):
        make_synthetic_dataset(root / pkg, n_segments=7)
        (root / pkg / "alignment.safetensors").unlink()
        jax_save_model(root / pkg / "alignment_model.safetensors",
                       aligner_case["params"])
    cfg = Config()
    for pkg in ("jax", "port"):
        cfg.dataset.path = str(root / pkg)
        if pkg == "jax":
            jax_align_text(jax_config(dump_json(cfg)), mc_jax)
            out[pkg] = read_safetensors(root / pkg / "alignment.safetensors")
        else:
            # one batch a split, BATCH rows of the 200-frame bucket
            shapes = []
            with pytest.MonkeyPatch.context() as mp:
                launch = stft_forward.launch
                mp.setattr(stft_forward, "launch", lambda x, *a: (
                    shapes.append(tuple(x.shape)), launch(x, *a))[1])
                out[pkg] = align_text(cfg, mc, device="cpu")
            assert shapes == [(16, 200 * HOP)] * 2
            assert read_safetensors(root / pkg / "alignment.safetensors"
                                    ).keys() == out[pkg].keys()
    return out, root


def test_align_text_matches_jax(aligned):
    out, root = aligned
    assert out["port"].keys() == out["jax"].keys() and len(out["port"]) == 7
    for name, want in out["jax"].items():
        got = out["port"][name]
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got[0], want[0]), name  # durations
        assert np.max(np.abs(got[1:] - want[1:])) <= ALIGN_PROB_ABS, name
        assert np.all((got[1:] >= 0) & (got[1:] <= 1))
    for split in ("scores_val.txt", "scores_train.txt"):
        got = (root / "port" / split).read_text().splitlines()
        want = (root / "jax" / split).read_text().splitlines()
        assert [g.split()[1] for g in got] == [w.split()[1] for w in want]
        for g, w in zip(got, want):
            assert abs(float(g.split()[0]) - float(w.split()[0])) <= \
                ALIGN_SCORE_REL * float(w.split()[0])


def test_states_to_durations_sum_to_the_frames(aligned):
    out, root = aligned
    from stylish_tts_tpu_torch.data.audio import wav_info

    for name, record in out["port"].items():
        frames = wav_info(root / "port" / "wav24" / name).frames // HOP
        assert int(record[0].sum()) == frames, name


def test_aligner_scorer_matches_jax(aligned, configs):
    """The transcript-free scorer over one aligner file: the mean
    per-frame forced-alignment log-probability of a phrase and a text,
    and -inf where the text cannot be embedded or the audio is too
    short."""
    from stylish_tts_tpu.dataprep.book import AlignerScorer as JaxScorer
    from stylish_tts_tpu.textfrontend import G2P as JaxG2P
    from stylish_tts_tpu_torch.dataprep.book import AlignerScorer
    from stylish_tts_tpu_torch.textfrontend import G2P

    _, root = aligned
    mc, mc_jax = configs
    path = str(root / "jax" / "alignment_model.safetensors")
    rng = np.random.default_rng(12)
    t = np.arange(2 * SR) / SR
    audio = (0.3 * np.sin(2 * np.pi * 150 * t) * (1 + np.sin(3 * t))
             + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    port = AlignerScorer(mc, path, device="cpu")
    jax_scorer = JaxScorer(mc_jax, path)
    cases = [(audio, "The quick brown fox."), (audio, "Hi!!"),
             (audio, ""), (audio[: 3 * HOP], "a long sentence here")]
    got = [port.score(a, text, G2P(use_espeak=False)) for a, text in cases]
    want = [jax_scorer.score(a, text, JaxG2P(use_espeak=False))
            for a, text in cases]
    assert np.isfinite(got[:2]).all()
    assert got[2] == want[2] == got[3] == want[3] == float("-inf")
    for g, w in zip(got[:2], want[:2]):
        assert abs(g - w) <= ALIGN_SCORE_REL * abs(w), (g, w)


# --------------------------------------------------------------------------- #
# the CLI on the CPU


def test_cli_train_align_then_align(tmp_path, capsys):
    data = tmp_path / "ds"
    make_synthetic_dataset(data, n_segments=6)
    for name in ("pitch", "alignment"):
        (data / f"{name}.safetensors").unlink()
    cfg = Config()
    cfg.dataset.path = str(data)
    cfg.training_plan.alignment.epochs = 1
    cfg.training.log_interval = 1
    (tmp_path / "c.json").write_text(dump_json(cfg))
    (tmp_path / "m.json").write_text(dump_json(tiny_model_config()))
    configs = ["--config", str(tmp_path / "c.json"), "--model-config",
               str(tmp_path / "m.json"), "--device", "cpu"]
    main(["train-align", *configs, "--out", str(tmp_path / "out"),
          "--workers", "2"])
    assert "trained to alignment" in capsys.readouterr().out
    shutil.copy(tmp_path / "out" / "alignment_model.safetensors", data)
    main(["align", *configs])
    assert "(6 segments)" in capsys.readouterr().out
    records = read_safetensors(data / "alignment.safetensors")
    assert len(records) == 6
    assert len((data / "scores_train.txt").read_text().splitlines()) == 4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """An inference artifact of the tiny config's models drawn from a
    seed."""
    mc = tiny_model_config()
    art = tmp_path_factory.mktemp("artifact")
    models = build_models(mc)
    gen = torch.Generator().manual_seed(3)
    for key in INFERENCE_MODELS:
        write_safetensors(art / f"{key}.safetensors", export_flax_params(
            key, init_params(models[key], gen)))
    (art / "model_config.json").write_text(dump_json(mc))
    return art


def _wav(path):
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == SR and f.getsampwidth() == 2
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def test_cli_speak_text_and_book(artifact, tmp_path, capsys):
    (tmp_path / "t.txt").write_text(
        "Dr. Smith read 3 books. He paid $25 for them! Was it the 2nd time?")
    main(["speak", "--artifact", str(artifact), "--text",
          str(tmp_path / "t.txt"), "--out", str(tmp_path / "t.wav"),
          "--device", "cpu"])
    assert f"wrote {tmp_path / 't.wav'}" in capsys.readouterr().out
    assert _wav(tmp_path / "t.wav").size > 3 * HOP
    (tmp_path / "b.md").write_text(
        "# One\n\nThe first chapter. It has two sentences.\n\n"
        "# Two\n\nThe *second* one.\n")
    main(["speak", "--artifact", str(artifact), "--book",
          str(tmp_path / "b.md"), "--out", str(tmp_path / "book"),
          "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "One" in printed and "Two" in printed
    wavs = sorted((tmp_path / "book").glob("chapter-*.wav"))
    assert [p.name for p in wavs] == ["chapter-001.wav", "chapter-002.wav"]
    assert all(_wav(p).size > 0 for p in wavs)


def test_cli_speak_takes_exactly_one_input(artifact, tmp_path):
    base = ["speak", "--artifact", str(artifact), "--out",
            str(tmp_path / "x.wav"), "--device", "cpu"]
    with pytest.raises(SystemExit):
        main(base)
    with pytest.raises(SystemExit):
        main(base + ["--phonemes", "abc", "--text", "t.txt"])

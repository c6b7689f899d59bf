"""A ``train`` cell: the program's train step
(``train/stages.py:make_train_step``) of the mix's ``stage`` on a pool of
seeded batches.  The reference follows the acoustic stage alone
(``reference/train/stages.py``); another stage is refused.

Set-up builds one train state from weights drawn on the card, and drives
it through its first ``check_steps`` steps on pool batches whose rows all
differ, through the window's own call and feed; those steps' losses, the
first gradient as AdamW got it and each parameter's change over them are
read, and the same state goes on through ``warm_steps`` more steps and then
the measured window.  Once the window has closed and the program's state is
freed, the reference (``reference/``, f32, TF32 off) takes the same
weights, batches and generator through the same steps, and
``compare.train_numbers`` decides ``correct``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from . import compare, traffic, weights
from .counts import flops as flop_counts
from .reference.config import Config as RefConfig
from .reference.config import load_model_config_json as load_ref_config
from .trace import CallRecorder, profiled, segment

STEP_STREAM, WEIGHT_STREAM = 11, 12


class PhaseClock:
    """Host seconds of each phase of a set-up, reported on stderr."""

    def __init__(self):
        self.last = time.perf_counter()
        self.phases: List[tuple] = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.phases.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        print("set-up phases: " + ", ".join(
            f"{name} {s:.2f} s" for name, s in self.phases), file=sys.stderr)


def stream_seed(seed: int, stream: int) -> int:
    """A torch seed of its own for each use of ``--seed``."""
    state = np.random.SeedSequence([seed, stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def audio_seconds(mc, mix: dict) -> float:
    return mix["batch"] * mix["frames"] * mc.hop_length / mc.sample_rate


# --------------------------------------------------------------------------- #
# weights and readings, the same for both sides


def drawn_weights(ref_mc, seed: int, device) -> Dict[str, Dict]:
    """The trained models', the MRD's and the SLM's weights (rule
    ``speech``: every leaf at a trained model's scale, so that every leaf
    takes a gradient from the first step; flax's initialisers leave the
    zero-initialised heads' inputs without one), drawn on ``device`` in a
    fixed order from the seed; the names and shapes are the reference's
    modules'."""
    from .reference import build

    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHT_STREAM))
    with torch.device("meta"):
        shapes = dict(build.training_models(ref_mc), slm=build.slm(ref_mc))
    drawn = {k: weights.draw(m, "speech", gen, device)
             for k, m in shapes.items()}
    weights.speech_levels(drawn, shapes["speech_predictor"].flow.n_flows)
    return drawn


def leaf_norms(state, beta1_of: Callable) -> tuple:
    """(first-gradient norms from AdamW's first moment, parameter tensors)
    by ``model.name``."""
    names, norms = [], []
    for key, model in state.models.items():
        opt = state.optimizers[key]
        beta1 = beta1_of(opt)
        for name, p in model.named_parameters():
            st = opt.state.get(p, {})
            m = st.get("exp_avg")
            names.append(f"{key}.{name}")
            norms.append(torch.zeros((), device=p.device) if m is None
                         else m.float().norm() / (1.0 - beta1))
    values = torch.stack(norms).tolist()
    return dict(zip(names, values))


def change_norms(state, start: Dict[str, Dict]) -> Dict[str, float]:
    names, norms = [], []
    for key, model in state.models.items():
        for name, p in model.named_parameters():
            names.append(f"{key}.{name}")
            norms.append((p.detach().float()
                           - start[key][name].float()).norm())
    return dict(zip(names, torch.stack(norms).tolist()))


def run_checked(step, state, feeds, gen, start) -> dict:
    """``len(feeds)`` steps of ``step``; the readings ``compare`` takes."""
    out = {"loss": [], "metrics": []}
    for i, feed in enumerate(feeds):
        state, metrics = step(state, feed(), gen)
        values = {k: float(v) for k, v in metrics.items()}
        out["loss"].append(values["loss"])
        out["metrics"].append(values)
        if i == 0:
            out["grad"] = leaf_norms(
                state, lambda opt: opt.param_groups[0]["betas"][0])
    out["change"] = change_norms(state, start)
    return out


# --------------------------------------------------------------------------- #
# the program


def _feed(pool: List[Dict[str, np.ndarray]], device):
    """Pinned host copies of the pool's batches, and a function that copies
    batch ``i`` (round the pool) to the card without waiting, as the
    loop's iterator does."""
    pinned = [{k: torch.from_numpy(v).pin_memory() for k, v in b.items()}
              for b in pool]

    def feed(i):
        return {k: v.to(device, non_blocking=True)
                for k, v in pinned[i % len(pinned)].items()}
    return feed


def _record_kernel_calls(rec: CallRecorder) -> None:
    from stylish_tts_tpu_torch.ops import spec_conv, stft_kernel

    rec.wrap(stft_kernel.stft_forward, "launch", "stft",
             lambda x, n_fft, hop, win: (*x.shape, n_fft, hop))
    rec.wrap(spec_conv, "spec_conv_forward", "spec_conv.forward",
             lambda x, w, b, s, leaky: (*x.shape[:3], w.shape[-1], s))
    rec.wrap(spec_conv, "spec_conv_dgrad", "spec_conv.dgrad",
             lambda d, w, width, s: (d.shape[0], d.shape[1], width,
                                     w.shape[-1], s))
    rec.wrap(spec_conv, "spec_conv_wgrad", "spec_conv.wgrad",
             lambda x, d, kt, s: (*x.shape[:3], kt, s))


def setup(cell, seed: int, device, warm: bool = True) -> dict:
    """The program's train state from drawn weights, driven through the
    check steps (their readings under ``prog``) and, with ``warm``, the
    warm steps."""
    from stylish_tts_tpu_torch.config import Config, load_model_config_json
    from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu_torch.ops.build import build
    from stylish_tts_tpu_torch.train.init import (build_train_state,
                                                  build_training_models)
    from stylish_tts_tpu_torch.train.stages import (STAGES, StageContext,
                                                    make_train_step)

    from .reference.config import load_model_config_json as ref_config
    from .reference.train.stages import STAGE

    mix, conf = cell.traffic, cell.config
    if mix["stage"] != STAGE:
        raise ValueError(f"{cell.name}: the reference follows the "
                         f"{STAGE!r} stage, not {mix['stage']!r}")
    model_json = json.dumps(conf["model"])
    mc, ref_mc = load_model_config_json(model_json), ref_config(model_json)
    cfg = Config()
    cfg.training.mixed_precision = conf["training"]["mixed_precision"]
    clock = PhaseClock()
    torch.empty(1, device=device)
    clock("cuda")
    build(["stft", "spec_conv"])
    clock("build")

    keys = STAGES[mix["stage"]].train_models + ["mrd"]
    drawn = drawn_weights(ref_mc, seed, device)
    with torch.device(device):
        models = build_training_models(mc, keys)
        slm = SLMFeatureExtractor(n_layers=mc.slm.layers)
    for key in keys:
        models[key].load_state_dict(drawn[key])
    slm.load_state_dict(drawn["slm"])
    slm.requires_grad_(False)
    state = build_train_state(mc, keys, models=models, device=device)
    ctx = StageContext(model_config=mc, config=cfg,
                       mel_mean=conf["training"]["mel_mean"],
                       mel_std=conf["training"]["mel_std"],
                       step_limit=conf["training"]["step_limit"],
                       slm=slm.eval())
    step = make_train_step(mix["stage"], ctx, conf["training"]["lr"])
    clock("weights and models")
    pool = traffic.train_pool(mc, mix, seed)
    feed = _feed(pool, device)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, STEP_STREAM))
    clock("batches")

    n_check = mix["check_steps"]
    prog = run_checked(step, state,
                       [lambda i=i: feed(i) for i in range(n_check)], gen,
                       drawn)
    clock("check steps")
    del drawn
    for i in range(mix["warm_steps"] if warm else 0):
        state, _ = step(state, feed(n_check + i), gen)
    torch.cuda.synchronize()
    clock("warm steps")
    clock.report()
    return dict(mc=mc, ref_mc=ref_mc, state=state, step=step,
                feed=feed, gen=gen, pool=pool, prog=prog,
                next=n_check + mix["warm_steps"])


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    mix, conf = cell.traffic, cell.config
    s = setup(cell, seed, device)
    state, step, feed, gen = s["state"], s["step"], s["feed"], s["gen"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    losses, n, first = [], 0, s["next"]
    marks, retries = [], _alloc_retries()
    with GcClock() as gc_clock:
        t0 = time.perf_counter()
        while True:
            state, metrics = step(state, feed(first + n), gen)
            losses.append(metrics["loss"])
            n += 1
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps_ms = [round(1e3 * (b - a), 1) for a, b in zip([t0] + marks, marks)]
    host = {"step_host_ms": steps_ms, "gc_s": gc_clock.seconds,
            "alloc_retries": _alloc_retries() - retries}
    print(f"window: {n} steps; host ms a step {steps_ms}; garbage "
          f"collection {gc_clock.seconds:.3f} s; allocator retries "
          f"{host['alloc_retries']}", file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    seg = None
    if trace:
        rec = CallRecorder()
        _record_kernel_calls(rec)
        units = mix["trace_steps"]
        try:
            with profiled() as held:
                for i in range(units):
                    state, _ = step(state, feed(first + n + i), gen)
        finally:
            rec.restore()
        seg = segment(held.events, units, rec.calls)
        shapes = {k: (v.shape, torch.from_numpy(v).dtype)
                  for k, v in s["pool"][0].items()}
        seg.flops = [flop_counts.train_step_flops(s["ref_mc"], RefConfig(),
                                                  shapes)] * units

    prog, pool, mc = s["prog"], s["pool"], s["mc"]
    del s, state, step, feed, metrics, losses
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, device, pool)
    numbers = compare.train_numbers(prog, ref)
    return {
        "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
        "attempted": n, "failed": failed,
        "e2e": {"train_audio_s_per_s": n * audio_seconds(mc, mix) / window_s,
                "train_peak_gib": peak / 2**30,
                "setup_s": setup_s},
        "numbers": numbers, "segment": seg, "host": host,
        "readings": dict(compare.train_details(prog, ref),
                         loss={"program": prog["loss"],
                               "reference": ref["loss"]},
                         window=host),
    }


def _alloc_retries() -> int:
    """The caching allocator's retries after a failed cudaMalloc (each
    frees the cache and synchronizes)."""
    return int(torch.cuda.memory_stats().get("num_alloc_retries", 0))


class GcClock:
    """Host seconds spent in Python's garbage collection inside the
    block."""

    def __init__(self):
        self.seconds, self._start = 0.0, None

    def _tick(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.seconds += time.perf_counter() - self._start
            self._start = None

    def __enter__(self):
        gc.callbacks.append(self._tick)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)


# --------------------------------------------------------------------------- #
# the reference


def reference_readings(cell, seed: int, device, pool, cast=None,
                       leaves: bool = True) -> dict:
    """The reference's readings over the check steps, from the same
    weights, batches and generator, in f32 with TF32 off.  With ``cast``
    (the control) each model's parameters and inputs, and the output of
    every leaf module inside it, pass through ``cast``: the reference
    computed in that precision wherever the program computes in bf16.
    ``leaves=False`` casts the parameters and inputs alone (the modules
    then compute in their type, as the program's do in bf16)."""
    from .reference import build
    from .reference.train import stages

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        conf, mix = cell.config, cell.traffic
        ref_mc = load_ref_config(json.dumps(conf["model"]))
        cfg = RefConfig()
        drawn = drawn_weights(ref_mc, seed, device)
        with torch.device("meta"):
            shells = dict(build.training_models(ref_mc),
                          slm=build.slm(ref_mc))
        models = build.loaded(shells, drawn, device)
        if cast is not None and leaves:
            for model in models.values():
                for sub in model.modules():
                    if next(sub.children(), None) is None:
                        sub.register_forward_hook(
                            lambda mod, args, out: stages.map_floats(out,
                                                                     cast))
        slm = models.pop("slm")
        state = build.train_state(models)
        ctx = stages.StageContext(
            model_config=ref_mc, config=cfg,
            mel_mean=conf["training"]["mel_mean"],
            mel_std=conf["training"]["mel_std"],
            step_limit=conf["training"]["step_limit"], slm=slm,
            cast=cast or stages.identity)
        step = stages.make_train_step(ctx, conf["training"]["lr"])
        gen = torch.Generator(device=device).manual_seed(
            stream_seed(seed, STEP_STREAM))
        feeds = [(lambda b=b: {k: torch.from_numpy(v).to(device)
                               for k, v in b.items()})
                 for b in pool[:mix["check_steps"]]]
        return run_checked(step, state, feeds, gen, drawn)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        gc.collect()
        torch.cuda.empty_cache()

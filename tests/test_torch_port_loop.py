"""The port's training loop on the CPU: its control flow against the JAX
package's loop, the OOM guard, the normalisation stats, the memory plan's
solve, and resume.

The two loops run on one synthetic dataset with each package's step
builders replaced by recording stand-ins (monkeypatched in each loop
module): they must feed the same batches in the same order, stage by
stage, at the same stage step and step limit, validate and save at the
same steps under the same checkpoint names, and end with equal manifests.
Resume runs the real port loop at a tiny config: a run stopped and resumed
from its checkpoint ends bit-equal to the uninterrupted one.
"""

from __future__ import annotations

import json
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylish_tts_tpu.data.batch_manager as jbm
import stylish_tts_tpu.train.loop as jloop
import stylish_tts_tpu_torch.data.batch_manager as pbm
import stylish_tts_tpu_torch.train.loop as ploop
from stylish_tts_tpu.config import load_config_json as jax_config
from stylish_tts_tpu.config import \
    load_model_config_json as jax_model_config
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.data.dataset import get_frame_count
from stylish_tts_tpu_torch.train.checkpoint import load_checkpoint
from stylish_tts_tpu_torch.train.state import (TrainState, restore_state,
                                               snapshot_state)
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   tiny_model_config)

STAGES = ("acoustic", "textual", "style", "duration")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while the module runs: the suite runs test
    files in parallel workers, and torch's default of one thread a core
    in each of them oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """12 segments of 0.3-0.5 s (10 train, in one bin) and a tiny model
    config."""
    root = tmp_path_factory.mktemp("loop_data")
    make_synthetic_dataset(root, n_segments=12)
    return root


def run_config(root, epochs=(2, 1, 1, 1), probe_batch_max=1) -> Config:
    cfg = Config()
    cfg.dataset.path = str(root)
    for stage, n in zip(STAGES, epochs):
        plan = getattr(cfg.training_plan, stage)
        plan.epochs = n
        plan.probe_batch_max = probe_batch_max
    cfg.training.log_interval = 2
    cfg.training.val_interval = 3
    cfg.training.save_interval = 4
    cfg.training.aot_memory_plan = False
    return cfg


# --------------------------------------------------------------------------- #
# the schedule against the JAX loop


class _JaxState:
    def __init__(self, step=0):
        self.step = jnp.asarray(step, jnp.int32)

    def replace(self, **kwargs):
        return _JaxState(kwargs.get("step", self.step))


class _PortState:
    def __init__(self):
        self.models, self.optimizers, self.step = {}, {}, 0
        self.disc_ema = {"mrd": torch.tensor(1.5)}


def _jax_builders(record):
    def make_train_step(stage, ctx, lr):
        def step(state, batch, rng, frozen=None):
            s = int(state.step)
            record.append(("train", stage, s, ctx.step_limit, lr,
                           np.asarray(batch["text"]).tolist(),
                           tuple(batch["audio_gt"].shape)))
            return state.replace(step=state.step + 1), {
                "loss": jnp.asarray(float(s)), "mel": jnp.asarray(1.0)}
        return step

    def make_eval_step(stage, ctx):
        def step(state, batch, rng, frozen=None):
            record.append(("eval", stage, int(state.step),
                           np.asarray(batch["text"]).tolist()))
            return {"loss": jnp.asarray(10.0 - int(state.step)),
                    "mel": jnp.asarray(1.0)}, None
        return step

    return make_train_step, make_eval_step


def _port_builders(record):
    def make_train_step(stage, ctx, lr):
        def step(state, batch, generator=None):
            s = state.step
            record.append(("train", stage, s, ctx.step_limit, lr,
                           batch["text"].tolist(),
                           tuple(batch["audio_gt"].shape)))
            state.step += 1
            return state, {"loss": torch.tensor(float(s)),
                           "mel": torch.tensor(1.0)}
        return step

    def make_eval_step(stage, ctx):
        def step(state, batch, generator=None):
            record.append(("eval", stage, state.step, batch["text"].tolist()))
            return {"loss": torch.tensor(10.0 - state.step),
                    "mel": torch.tensor(1.0)}, None
        return step

    return make_train_step, make_eval_step


def _record_epochs(mp, cls, record):
    original = cls.epoch_iterator

    def epoch_iterator(self, **kwargs):
        record.append(("epoch", kwargs["stage"], kwargs["epoch"],
                       kwargs.get("skip_batches", 0),
                       kwargs.get("shuffle", True)))
        return original(self, **kwargs)

    mp.setattr(cls, "epoch_iterator", epoch_iterator)


def _run_jax(cfg, mc, out, stage, max_steps):
    record = []
    with pytest.MonkeyPatch.context() as mp:
        train, evaluate = _jax_builders(record)
        mp.setattr(jloop, "make_train_step", train)
        mp.setattr(jloop, "make_eval_step", evaluate)
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
        mp.setattr(jloop, "save_checkpoint", lambda out_dir, name, state,
                   manifest, *a, **k: record.append(
                       ("save", name, asdict(manifest))))
        _record_epochs(mp, jbm.BatchManager, record)
        manifest = jloop.train_model(
            config=jax_config(dump_json(cfg)),
            model_config=jax_model_config(dump_json(mc)), out_dir=str(out),
            stage_name=stage, max_steps=max_steps, workers=2)
    return record, asdict(manifest)


def _run_port(cfg, mc, out, stage, max_steps):
    record = []
    with pytest.MonkeyPatch.context() as mp:
        train, evaluate = _port_builders(record)
        mp.setattr(ploop, "make_train_step", train)
        mp.setattr(ploop, "make_eval_step", evaluate)
        mp.setattr(ploop, "build_train_state", lambda *a, **k: _PortState())
        mp.setattr(ploop, "init_slm", lambda *a: torch.nn.Identity())
        mp.setattr(ploop, "snapshot_state", lambda *a: None)
        mp.setattr(ploop, "save_checkpoint", lambda out_dir, name, state,
                   manifest, *a, **k: record.append(
                       ("save", name, asdict(manifest))))
        _record_epochs(mp, pbm.BatchManager, record)
        manifest = ploop.train_model(
            config=cfg, model_config=mc, out_dir=str(out), stage_name=stage,
            max_steps=max_steps, workers=2, device="cpu")
    return record, asdict(manifest)


@pytest.fixture(scope="module", params=[("acoustic", None), ("textual", 5)],
                ids=["chain", "from_textual_max_steps"])
def schedules(request, dataset, tmp_path_factory):
    stage, max_steps = request.param
    cfg, mc = run_config(dataset), tiny_model_config()
    out = tmp_path_factory.mktemp("schedule")
    return {pkg: run(cfg, mc, out / pkg, stage, max_steps)
            for pkg, run in (("jax", _run_jax), ("port", _run_port))}, out


def test_loop_schedule_matches_jax(schedules):
    runs, _ = schedules
    (jax_record, jax_manifest), (port_record, port_manifest) = \
        runs["jax"], runs["port"]
    kinds = [r[0] for r in port_record]
    assert kinds.count("train") >= 5 and "eval" in kinds and "save" in kinds
    assert len(port_record) == len(jax_record)
    for got, want in zip(port_record, jax_record):
        assert got == want
    assert port_manifest == jax_manifest


def test_loop_normalization_matches_jax(schedules):
    """Each package's loop computed the stats on the same dataset: the
    port on its plain STFT, the JAX package through XLA."""
    _, out = schedules
    for stage in ("acoustic", "textual"):
        path = out / "port" / stage / "normalization.json"
        if not path.is_file():
            continue
        got = json.loads(path.read_text())
        want = json.loads((out / "jax" / stage / "normalization.json")
                          .read_text())
        assert got.keys() == want.keys() and got["frames"] == want["frames"]
        for key, value in want.items():
            assert abs(got[key] - value) <= 1e-5 * abs(value), (key, got,
                                                                 want)
        return
    pytest.fail("no normalization.json written")


# --------------------------------------------------------------------------- #
# the OOM guard (mirrors tests/test_loop_guard.py)


class _BM:
    divisor = 1

    def __init__(self, bs=8):
        self.sizes = {"3": bs}
        self.saved = []

    def get_batch_size(self, b):
        return self.sizes[str(b)]

    def set_batch_size(self, b, v):
        self.sizes[str(b)] = v
        self.saved.append((b, v))


def _batch(rows=8):
    return {"text": np.zeros((rows, 4), np.int32), "bin": 3,
            "global_batch_size": rows}


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")


def test_guard_shrinks_and_persists_on_oom():
    calls = []

    def step_fn(state, batch, generator):
        calls.append(batch["text"].shape[0])
        if batch["text"].shape[0] > 8:
            raise _oom()
        return state, {"loss": torch.zeros(())}

    bm, skip = _BM(32), set()
    state, metrics = ploop._guarded_step(step_fn, _tiny_state(), _batch(32),
                                         None, bm, "cpu", skip)
    assert metrics is not None
    assert calls == [32, 16, 8]  # halved twice, then fits
    assert bm.sizes["3"] == 8 and bm.saved == [(3, 16), (3, 8)]
    assert skip == set()


def test_guard_latches_the_bin_after_three_ooms():
    calls = []

    def step_fn(state, batch, generator):
        calls.append(batch["text"].shape[0])
        raise _oom()

    bm, skip = _BM(32), set()
    _, metrics = ploop._guarded_step(step_fn, _tiny_state(), _batch(32),
                                     None, bm, "cpu", skip)
    assert metrics is None and skip == {3}
    assert calls == [32, 16, 8] and bm.sizes["3"] == 4


def _tiny_state():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return TrainState(models={"m": model},
                      optimizers={"m": torch.optim.AdamW(model.parameters())},
                      disc_ema={"mrd": torch.tensor(1.5)}, step=7)


def _tensors(state, generator):
    snap = snapshot_state(state, generator)
    return snap["models"], snap["optimizers"], snap["disc_ema"], \
        snap["step"], snap["generator"]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_guard_restores_the_state_after_a_first_visit_oom():
    """The first step at new batch shapes writes parameters, a
    buffer, first moments, the EMA, the step and the generator before it
    runs out of memory: the retry starts from the exact pre-step state."""
    state, gen = _tiny_state(), torch.Generator().manual_seed(4)
    # a second shape that has run before: its moments exist
    model, opt = state.models["m"], state.optimizers["m"]
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    before = _tensors(state, gen)
    entries = []

    def step_fn(state, batch, generator):
        entries.append(_tensors(state, generator))
        torch.rand(3, generator=generator)
        model = state.models["m"]
        model.train()
        model(torch.randn(batch["text"].shape[0], 3)).sum().backward()
        state.optimizers["m"].step()
        state.disc_ema["mrd"] = state.disc_ema["mrd"] * 0.5
        state.step += 1
        if len(entries) == 1:
            raise _oom()
        return state, {"loss": torch.zeros(())}

    bm, validated = _BM(16), set()
    out, metrics = ploop._guarded_step(step_fn, state, _batch(16), gen, bm,
                                       "cpu", set(), validated=validated)
    assert metrics is not None and out.step == 8
    assert len(entries) == 2
    _assert_same(entries[1], before)  # restored exactly
    assert bm.sizes["3"] == 8
    assert validated == {(("text", (8, 4)),)}  # the shapes that ran


def test_guard_validated_shape_takes_no_snapshot(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("snapshot taken for a validated shape")

    monkeypatch.setattr(ploop, "snapshot_state", boom)
    _, metrics = ploop._guarded_step(
        lambda s, b, g: (s, {"loss": torch.zeros(())}), _tiny_state(),
        _batch(8), None, _BM(8), "cpu", set(),
        validated={(("text", (8, 4)),)})
    assert metrics is not None


@pytest.mark.parametrize("batch", ["tokens", "rows"])
def test_guard_new_shape_in_a_seen_bin_takes_a_snapshot(batch):
    """A new text bucket, or a partial last batch, at a (bin, batch size)
    that has run before is a first visit: the step updates the state in
    place, so its OOM must restore from a snapshot."""
    seen = np.zeros((8, 4), np.int32)
    new = {"tokens": np.zeros((8, 6), np.int32),
           "rows": np.zeros((5, 4), np.int32)}[batch]
    validated = {ploop._shape_key({"text": seen, "bin": 3}, 8)}
    snaps = {"snapshots": 0, "snapshot_s": 0.0, "oom": 0}
    _, metrics = ploop._guarded_step(
        lambda s, b, g: (s, {"loss": torch.zeros(())}), _tiny_state(),
        {"text": new, "bin": 3, "global_batch_size": new.shape[0]}, None,
        _BM(8), "cpu", set(), validated=validated, record=snaps)
    assert metrics is not None and snaps["snapshots"] == 1
    assert validated == {(("text", (8, 4)),), (("text", new.shape),)}


def test_guard_raises_other_errors():
    def step_fn(state, batch, generator):
        raise RuntimeError("shapes do not match")

    with pytest.raises(RuntimeError, match="shapes do not match"):
        ploop._guarded_step(step_fn, _tiny_state(), _batch(8), None, _BM(8),
                            "cpu", set())


def test_drain_metrics_means_and_key_errors():
    logs = [{"loss": torch.tensor(1.0), "mel": torch.tensor(2.0)},
            {"loss": torch.tensor(3.0), "mel": torch.tensor(4.0)}]
    assert ploop._drain_metrics(logs) == {"loss": 2.0, "mel": 3.0}
    assert ploop._drain_metrics([]) == {}
    with pytest.raises(KeyError):
        ploop._drain_metrics([{"loss": torch.tensor(1.0)},
                              {"other": torch.tensor(1.0)}])


def test_snapshot_restore_round_trip_and_missing_moments():
    state, gen = _tiny_state(), torch.Generator().manual_seed(1)
    before = _tensors(state, gen)
    snap = snapshot_state(state, gen)
    model = state.models["m"]
    model.train()
    model(torch.randn(4, 3)).sum().backward()
    state.optimizers["m"].step()  # creates moments
    torch.rand(2, generator=gen)
    state.step = 99
    restore_state(state, snap, gen)
    _assert_same(_tensors(state, gen), before)
    assert not state.optimizers["m"].state  # the created moments are gone
    assert all(p.grad is None for p in model.parameters())


# --------------------------------------------------------------------------- #
# the memory plan's solve, against the JAX formula


def _plan_manager(pkg, tmp_path, root):
    from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
    from stylish_tts_tpu.data.dataset import FilePathDataset as JaxDataset
    from stylish_tts_tpu.text import TextCleaner as JaxCleaner
    from stylish_tts_tpu_torch.config import ModelConfig
    from stylish_tts_tpu_torch.data.dataset import (FilePathDataset,
                                                    get_data_path_list)
    from stylish_tts_tpu_torch.text import TextCleaner

    ds_cls, cleaner, mc, bm = (
        (JaxDataset, JaxCleaner, JaxModelConfig, jbm) if pkg == "jax"
        else (FilePathDataset, TextCleaner, ModelConfig, pbm))
    dataset = ds_cls(
        data_list=get_data_path_list(root / "train-list.txt"),
        root_path=root / "wav24", text_cleaner=cleaner(),
        model_config=mc(), pitch_path=str(root / "pitch.safetensors"),
        alignment_path=str(root / "alignment.safetensors"))
    return bm.BatchManager(dataset, tmp_path / pkg, "acoustic",
                           probe_batch_max=8)


@pytest.fixture(scope="module")
def plan_dataset(tmp_path_factory):
    """18 segments of 0.7-1.3 x 1.5 s: train segments over six bins."""
    root = tmp_path_factory.mktemp("plan_data")
    make_synthetic_dataset(root, n_segments=20, seconds=1.5)
    return root


MODELS = {
    # fixed 3 GiB + 2 MiB per sample-frame, exactly affine
    "affine": lambda b, f: 3 * 2**30 + 2**21 * b * f,
    # 30 % more per sample-frame past batch 12: validation shrinks
    "convex": lambda b, f: 3 * 2**30 + 2**21 * b * f * (1.3 if b > 12
                                                          else 1.0),
    # out of memory past batch 10: validation takes 3/4 steps
    "oom_above_10": lambda b, f: None if b > 10 else 3 * 2**30
    + 2**21 * b * f,
    "probe_oom": lambda b, f: None,  # the first probe fails
    "degenerate": lambda b, f: 4 * 2**30,  # no growth with frames
    "fixed_over_budget": lambda b, f: 30 * 2**30 + b * f,
}


@pytest.mark.parametrize("model", list(MODELS))
def test_refine_plan_matches_jax(model, plan_dataset, tmp_path, monkeypatch):
    budget = 14000 * 2**20
    bytes_of = MODELS[model]

    class Compiled:
        def __init__(self, b, f):
            self.b, self.f = b, f

        def compile(self):
            return self

        def memory_analysis(self):
            y = bytes_of(self.b, self.f)
            if y is None:
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
            return type("A", (), dict(temp_size_in_bytes=y,
                                      argument_size_in_bytes=0,
                                      output_size_in_bytes=0))()

    class Jitted:
        def lower(self, state, spec, rng, frozen):
            return Compiled(spec["text"].shape[0], spec["pitch"].shape[1])

    monkeypatch.setattr(jax, "jit", lambda fn, **k: Jitted())
    jm = _plan_manager("jax", tmp_path, plan_dataset)
    assert len(jm.time_bins) >= 4
    heuristic = dict(jm.batch_sizes)
    jm.refine_plan_aot(None, None, tiny_model_config(),
                       stage_inputs=["text", "pitch"], budget_bytes=budget)

    pm = _plan_manager("port", tmp_path, plan_dataset)
    assert pm.batch_sizes == heuristic and pm.freshly_planned
    calls = []

    def measure(b, bin_num):
        calls.append((b, bin_num))
        return bytes_of(b, get_frame_count(bin_num))

    fit = pm.refine_plan(measure, budget_bytes=budget)
    assert pm.batch_sizes == jm.batch_sizes
    kept = model in ("probe_oom", "degenerate", "fixed_over_budget")
    assert (fit["kept"] is not None) == kept
    assert (pm.batch_sizes == heuristic) == kept
    if not kept:
        assert all(v >= 1 for v in pm.batch_sizes.values())
        assert json.loads(pm.batch_file().read_text()) == pm.batch_sizes
        assert calls[:2] == [(8, max(pm.time_bins)),
                             (8, sorted(pm.time_bins)[len(pm.time_bins) // 2])]


def test_probe_batch_shapes():
    from stylish_tts_tpu_torch.train.stages import STAGES

    mc = tiny_model_config()
    arrays = pbm.probe_batch_arrays(mc, 3, 20, STAGES["acoustic"].inputs)
    frames = get_frame_count(20)
    tokens = max(32, min(512, frames * 192 // 460))
    assert arrays["text"].shape == (3, tokens)
    assert arrays["alignment"].shape == (3, tokens, frames)
    assert np.all(arrays["alignment"].sum(axis=1) == 1.0)  # one token a frame
    assert np.all(arrays["alignment"].sum(axis=2) >= 1.0)  # every token used
    assert arrays["audio_gt"].shape == (3, frames * mc.hop_length)
    assert set(pbm.probe_batch_arrays(mc, 1, 0, STAGES["duration"].inputs)) \
        == {"text", "text_length", "alignment", "audio_gt"}
    with pytest.raises(RuntimeError, match="card"):
        pbm.step_memory(None, None, mc, ["text"], "cpu")


# --------------------------------------------------------------------------- #
# resume


def _resume_config(root) -> Config:
    cfg = run_config(root, epochs=(1, 1, 1, 2), probe_batch_max=1)
    cfg.training.log_interval = 1
    cfg.training.save_interval = 100
    cfg.training.val_interval = 2
    return cfg


def _final_state(out, stage, mc):
    from stylish_tts_tpu_torch.train.init import build_train_state

    state = build_train_state(mc, ploop.STATE_MODELS, device="cpu",
                              generator=torch.Generator().manual_seed(99))
    gen = torch.Generator()
    _, manifest, norm, meta = load_checkpoint(
        out / stage / "checkpoint_final", state, gen)
    return state, gen.get_state(), asdict(manifest), meta


@pytest.fixture(scope="module")
def resumed(dataset, tmp_path_factory):
    """Duration-stage steps 1-2 straight (run A); step 1, stopped, then
    resumed from the checkpoint to step 2 (run B).  The plan's one batch
    of the 10 train segments gives 1 step an epoch, so the resumed run
    starts epoch 2; both validate at step 2 (the whole inference path,
    speech included).  The loop's resume does not depend on the stage;
    the acoustic step's own resume is held in test_torch_port_runtime.py."""
    from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config

    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.mel_style_encoder.max_channels = 64
    out = tmp_path_factory.mktemp("resume")
    cfg = _resume_config(dataset)
    for name in ("a", "b"):
        (out / name / "duration").mkdir(parents=True)
        # the 10 train segments in one batch: 1 step an epoch
        (out / name / "duration" / "duration_batch_sizes.json").write_text(
            '{"0": 10}')
    run = dict(config=cfg, model_config=mc, stage_name="duration",
               workers=2, device="cpu")
    ploop.train_model(out_dir=str(out / "a"), max_steps=2, **run)
    ploop.train_model(out_dir=str(out / "b"), max_steps=1, **run)
    stopped = _final_state(out / "b", "duration", mc)
    ploop.train_model(out_dir=str(out / "b"), max_steps=2,
                      checkpoint=str(out / "b" / "duration"
                                     / "checkpoint_final"), **run)
    return {name: _final_state(out / name, "duration", mc)
            for name in ("a", "b")}, stopped


def test_resume_equals_the_uninterrupted_run(resumed):
    runs, stopped = resumed
    (a, gen_a, man_a, meta_a), (b, gen_b, man_b, meta_b) = runs["a"], \
        runs["b"]
    assert stopped[2]["current_step"] == 1 and man_a["current_step"] == 2
    assert man_a["current_epoch"] == 2
    assert man_a["best_loss"] < float("inf")  # validated at step 2
    assert man_a == man_b
    assert man_a["total_trained_audio_seconds"] > 0
    assert meta_a["train_state"] == meta_b["train_state"]
    assert torch.equal(gen_a, gen_b)
    assert not torch.equal(gen_a, stopped[1])
    for key in a.models:
        sa, sb = a.models[key].state_dict(), b.models[key].state_dict()
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (key, name)
        oa, ob = a.optimizers[key].state_dict(), \
            b.optimizers[key].state_dict()
        assert oa["state"].keys() == ob["state"].keys(), key
        for i, entry in oa["state"].items():
            for name, value in entry.items():
                assert torch.equal(value, ob["state"][i][name]), (key, i)
    moved = stopped[0].models["duration_predictor"].state_dict()
    assert any(not torch.equal(v, a.models["duration_predictor"]
                               .state_dict()[n]) for n, v in moved.items())
    assert man_a["stage"] == "duration"

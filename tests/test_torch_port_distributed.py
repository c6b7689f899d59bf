"""Data-parallel training over processes: two gloo ranks on the CPU, each
on its contiguous half of a batch, against one process on the whole batch
(whose steps the other test files hold against the JAX package).

Each case runs in two spawned processes that join a process group on a
free localhost port with a 120 s collective timeout, under a deadline
that kills them, so a hang fails the test instead of the suite's clock.
The workers import no JAX.
"""

from __future__ import annotations

import math
import os
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 2
DEADLINE_S = 150.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_config():
    from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config

    mc = tiny_model_config()
    mc.slm.layers = 1
    mc.text_encoder.dropout = 0.0
    mc.pitch_energy_predictor.dropout = 0.0
    return mc


def _block(arrays: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous block of every array's rows."""
    out = {}
    for k, v in arrays.items():
        per = v.shape[0] // world
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[rank * per:(rank + 1) * per]))
    return out


def _setup(stage: str, seed: int = 0):
    from stylish_tts_tpu_torch.config import Config
    from stylish_tts_tpu_torch.models.norms import Dropout
    from stylish_tts_tpu_torch.train.init import build_train_state, init_slm
    from stylish_tts_tpu_torch.train.stages import STAGES, StageContext

    mc = _tiny_config()
    state = build_train_state(mc, STAGES[stage].models, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    for module in state.models.values():
        for m in module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    cfg = Config()
    cfg.training.mixed_precision = "no"
    slm = None if stage == "alignment" else init_slm(
        mc, torch.Generator().manual_seed(seed + 7))
    ctx = StageContext(model_config=mc, config=cfg, mel_mean=-4.0,
                       mel_std=4.0, step_limit=100, slm=slm)
    return state, ctx


def _slm_loss_f32(ctx, audio_gt, audio_pred):
    """The SLM loss with the frozen SLM in f32 (the step's runs it in
    bf16)."""
    from stylish_tts_tpu_torch.models.slm import slm_feature_loss
    from stylish_tts_tpu_torch.ops.resample import resample

    sr, slm_sr = ctx.model_config.sample_rate, ctx.model_config.slm.sr
    with torch.no_grad():
        gt = ctx.slm(resample(audio_gt, sr, slm_sr))
    return slm_feature_loss(gt, ctx.slm(resample(audio_pred, sr, slm_sr)))


def _recorded_step(stage: str, state, ctx, batch, **hooks):
    """One train step; returns (metrics, each trained module's gradients
    as the optimizer sees them, after the ranks' reduction).

    The MRD and the frozen SLM run in f32 here, not in the step's bf16: a
    bf16 product's rounding depends on the GEMM's blocking, which the CPU
    picks by the batch's rows, so half a batch would not round as the
    whole one does; the reductions, what this file tests, are the same in
    either type."""
    import functools

    from stylish_tts_tpu_torch.train import stages

    grads = {}
    real = stages.apply_updates
    real_gan = stages.gan_losses
    if ctx.slm is not None:
        ctx.slm = ctx.slm.float()
        ctx.slm_loss = functools.partial(_slm_loss_f32, ctx)

    def record(optimizer, lr):
        key = next(k for k, o in state.optimizers.items() if o is optimizer)
        grads[key] = {n: p.grad.detach().clone()
                      for n, p in state.models[key].named_parameters()
                      if p.grad is not None}
        real(optimizer, lr)

    stages.apply_updates = record
    stages.gan_losses = functools.partial(real_gan, dtype=torch.float32)
    try:
        _, metrics = stages.make_train_step(stage, ctx, 1e-4)(
            state, batch, torch.Generator().manual_seed(3), **hooks)
    finally:
        stages.apply_updates = real
        stages.gan_losses = real_gan
    return {k: float(v) for k, v in metrics.items()}, grads


def acoustic_case(rank: int, world: int, payload: dict) -> dict:
    from stylish_tts_tpu_torch.parallel import mesh

    state, ctx = _setup("acoustic")
    batch = _block(payload["batch"], rank, world)
    noise = _block({"n": payload["noise"]}, rank, world)["n"]
    metrics, grads = _recorded_step(
        "acoustic", state, ctx, batch, sample=False, pcph_noise=noise,
        pcph_phase=torch.zeros(1, 1))
    return {"metrics": metrics, "grads": grads,
            "ema": float(state.disc_ema["mrd"]),
            "differ": mesh.check_equal(list(state.models.values()))}


def alignment_case(rank: int, world: int, payload: dict) -> dict:
    from stylish_tts_tpu_torch.parallel import mesh
    from stylish_tts_tpu_torch.train.stages import end_alignment_epoch

    state, ctx = _setup("alignment")
    batch = _block(payload["batch"], rank, world)
    metrics, grads = _recorded_step("alignment", state, ctx, batch)
    end_alignment_epoch(state)
    aligner = state.models["text_aligner"]
    return {"metrics": metrics, "grads": grads,
            "priors": {k: v.clone() for k, v in state.priors.items()},
            "stats": {n: b.clone() for n, b in aligner.named_buffers()},
            "differ": mesh.check_equal([aligner])}


def init_case(rank: int, world: int, payload: dict) -> dict:
    from stylish_tts_tpu_torch.parallel import mesh, multihost

    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    total = mesh.sum(x)
    total.backward()
    gathered = mesh.gather(torch.tensor([[rank]]))
    return {"rank": multihost.process_index(),
            "count": multihost.process_count(),
            "main": multihost.is_main_process(), "sum": float(total),
            "grad": x.grad.clone(), "gathered": gathered.reshape(-1).tolist(),
            "max": mesh.max_int(10 + rank, "cpu"),
            **guard_case(rank, world, payload)}


def guard_case(rank: int, world: int, payload: dict) -> dict:
    """The OOM guard over the ranks: rank 1 alone runs out of memory at
    the global batch of 16 (8 rows a rank); both ranks restore, halve the
    global size to 8 together and retry at 4 rows each.  Each rank's
    tokens differ, so the batch's token axis is padded to the longest."""
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.train.state import TrainState

    class Sizes:
        divisor = world

        def __init__(self):
            self.sizes = {"3": 16}

        def get_batch_size(self, b):
            return self.sizes[str(b)]

        def set_batch_size(self, b, v):
            self.sizes[str(b)] = v

    calls = []

    def step_fn(state, batch, generator):
        calls.append(tuple(batch["text"].shape))
        if rank == 1 and batch["text"].shape[0] > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return state, {"loss": torch.zeros(())}

    model = torch.nn.Linear(3, 4)
    state = TrainState(models={"m": model},
                       optimizers={"m": torch.optim.AdamW(
                           model.parameters())},
                       disc_ema={}, step=0)
    sizes = Sizes()
    batch = {"text": np.zeros((8, 4 + 3 * rank), np.int32), "bin": 3,
             "global_batch_size": 16}
    _, metrics = loop._guarded_step(step_fn, state, batch, None, sizes,
                                    "cpu", set(), validated=set())
    return {"calls": calls, "size": sizes.sizes["3"],
            "ok": metrics is not None}


class _Sizes:
    """The batch manager's sizes that the guard reads and persists: bin 3
    at a global batch of 16."""

    def __init__(self, world: int):
        self.divisor = world
        self.sizes = {"3": 16}

    def get_batch_size(self, b):
        return self.sizes[str(b)]

    def set_batch_size(self, b, v):
        self.sizes[str(b)] = v


def _collectives_then_oom(rank: int, world: int, fail_after: dict,
                          rows: int) -> torch.Tensor:
    """Two ``mesh.sum`` collectives; a rank in ``fail_after`` runs out of
    memory after ``fail_after[rank]`` of them while the global batch has
    more than 8 rows."""
    from stylish_tts_tpu_torch.parallel import mesh

    total = torch.zeros(())
    for i in range(2):
        if fail_after.get(rank) == i and rows * world > 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        total = total + mesh.sum(torch.ones(()))
    return total


def _guard_outcome(run) -> dict:
    """How ``run()`` ended on this rank (its error, or what it returned),
    how long it took and the collectives the rank issued."""
    from stylish_tts_tpu_torch.parallel import mesh

    before = mesh.collective_count()
    t0 = time.monotonic()
    try:
        outcome = {"returned": run()}
    except RuntimeError as exc:
        outcome = {"error": type(exc).__name__, "message": str(exc)}
    return {**outcome, "seconds": time.monotonic() - t0,
            "collectives": mesh.collective_count() - before}


def midstep_case(rank: int, world: int, payload: dict) -> dict:
    """An OOM among a step's collectives: each rank's step runs two
    ``mesh`` collectives, and a rank in ``payload["fail_after"]`` runs out
    of memory after that many of them at the global batch of 16; a rank
    that failed waits ``payload["wait_s"]`` for the others at the guard.
    Returns ``_guard_outcome`` (the step's metrics, and the size the bin
    ended at)."""
    from stylish_tts_tpu_torch.parallel import mesh
    from stylish_tts_tpu_torch.train import loop
    from stylish_tts_tpu_torch.train.state import TrainState

    mesh.GUARD_WAIT_S = payload["wait_s"]
    sizes = _Sizes(world)

    def step_fn(state, batch, generator):
        rows = batch["text"].shape[0]
        return state, {"loss": _collectives_then_oom(
            rank, world, payload["fail_after"], rows)}

    model = torch.nn.Linear(3, 4)
    state = TrainState(models={"m": model},
                       optimizers={"m": torch.optim.AdamW(
                           model.parameters())},
                       disc_ema={}, step=0)
    batch = {"text": np.zeros((16 // world, 4), np.int32), "bin": 3,
             "global_batch_size": 16}

    def run():
        _, metrics = loop._guarded_step(step_fn, state, batch, None, sizes,
                                        "cpu", set(), validated=set())
        return {"metrics": None if metrics is None else
                {k: float(v) for k, v in metrics.items()},
                "size": sizes.sizes["3"]}

    return _guard_outcome(run)


def probe_case(rank: int, world: int, payload: dict) -> dict:
    """The memory probe over the ranks (``loop._probe_on_ranks``) with a
    ``measure`` that runs the collectives of ``midstep_case``'s step and,
    as ``step_memory`` does, returns None where that step ran out of
    memory, else a peak of 1000 + rank bytes."""
    from stylish_tts_tpu_torch.parallel import mesh
    from stylish_tts_tpu_torch.train import loop

    mesh.GUARD_WAIT_S = payload["wait_s"]

    def measure(batch: int, bin_num: int):
        try:
            _collectives_then_oom(rank, world, payload["fail_after"],
                                  batch // world)
        except torch.cuda.OutOfMemoryError:
            return None
        return 1000 + rank

    return _guard_outcome(lambda: loop._probe_on_ranks(measure, "cpu", 16,
                                                       3))


def cli_case(rank: int, world: int, payload: dict) -> dict:
    """CLI ``train --distributed`` with the coordinator, the count and the
    rank given: one acoustic step and a validation; at the stage's end the
    ranks' models are compared."""
    import functools

    from stylish_tts_tpu_torch import cli
    from stylish_tts_tpu_torch.parallel import mesh
    from stylish_tts_tpu_torch.train import loop

    seen = {}

    def hook(event, stage, state):
        if event == "end":
            seen["differ"] = mesh.check_equal(list(state.models.values()))

    root = Path(payload["root"])
    real = loop.train_model
    loop.train_model = functools.partial(real, on_stage=hook)
    try:
        cli.main(["train", "--config", str(root / "config.json"),
                  "--model-config", str(root / "model.json"), "--out",
                  str(root / "out"), "--max-steps", "1", "--device", "cpu",
                  "--workers", "1", "--distributed", "--coordinator",
                  payload["coordinator"], "--num-processes", str(world),
                  "--process-id", str(rank)])
    finally:
        loop.train_model = real
    return {"differ": seen["differ"],
            "joined": torch.distributed.is_initialized()}


CASES = {"acoustic": acoustic_case, "alignment": alignment_case,
         "init": init_case, "cli": cli_case, "midstep": midstep_case,
         "probe": probe_case}


def _worker(rank: int, world: int, port: int, out_dir: str, cases: list,
            payload: dict, env: bool, timeout_s: float) -> None:
    """Join the group (torchrun's environment, or the coordinator, count
    and rank; the CLI case joins by itself), run ``cases`` in order and
    save each result."""
    torch.set_num_threads(2)
    from stylish_tts_tpu_torch.parallel.multihost import (
        initialize_distributed, shutdown_distributed)

    if cases == ["cli"]:
        payload = {"cli": {**payload["cli"],
                           "coordinator": f"127.0.0.1:{port}"}}
    elif env:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        initialize_distributed(device="cpu", timeout_s=timeout_s)
    else:
        initialize_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cpu", timeout_s=timeout_s)
    try:
        for case in cases:
            torch.save(CASES[case](rank, world, payload[case]),
                       Path(out_dir) / f"{case}_{rank}.pt")
    finally:
        shutdown_distributed()


def start_ranks(cases: list, payload: dict, out_dir: Path,
                env: bool = False, timeout_s: float = 120.0,
                world: int = WORLD):
    """``world`` spawned processes running ``cases`` in a group whose
    collectives time out after ``timeout_s``; see ``join_ranks``."""
    return mp.start_processes(
        _worker, args=(world, _free_port(), str(out_dir), cases, payload,
                       env, timeout_s),
        nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, cases: list, out_dir: Path,
               deadline_s: float = DEADLINE_S) -> dict:
    """{case: each rank's result}; the processes are killed and the test
    fails past ``deadline_s``."""
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{cases}: ranks still running after "
                            f"{deadline_s} s (a collective hangs)")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return {case: [torch.load(out_dir / f"{case}_{r}.pt")
                   for r in range(len(ctx.processes))] for case in cases}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _assert_grads_close(got: dict, want: dict, rel: float = 1e-5):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys(), key
        scale = max(float(g.abs().max()) for g in want[key].values())
        for name, g in want[key].items():
            err = float((got[key][name] - g).abs().max())
            assert err <= rel * scale, f"{key}.{name}: {err:.3e} " \
                                       f"> {rel:.0e} x {scale:.3e}"


def _assert_metrics_close(got: dict, want: dict, rel: float = 1e-6):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert math.isfinite(v), k
        assert abs(got[k] - v) <= rel * abs(v) + 1e-12, (k, got[k], v)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, few_threads):
    """The init, acoustic and alignment cases on two ranks joined from
    torchrun's environment (one spawn), and the one-process acoustic and
    alignment references on the whole batches, computed meanwhile."""
    from test_torch_port_helpers import acoustic_batch

    out = tmp_path_factory.mktemp("ranks")
    mc = _tiny_config()
    batch, noise = acoustic_batch(mc, seed=5, batch=4, tokens=8, frames=16)
    align, _ = acoustic_batch(mc, seed=6, batch=4, tokens=8, frames=24)
    payload = {"init": {}, "acoustic": {"batch": batch, "noise": noise},
               "alignment": {"batch": {k: align[k] for k in (
                   "text", "text_length", "audio_gt")}}}
    cases = ["init", "acoustic", "alignment"]
    ctx = start_ranks(cases, payload, out, env=True)
    want = {"acoustic": acoustic_case(0, 1, payload["acoustic"]),
            "alignment": alignment_case(0, 1, payload["alignment"])}
    return join_ranks(ctx, cases, out), want


def test_multihost_init_and_collectives(two_ranks):
    """Joining from torchrun's environment (the CLI test joins by the
    coordinator, count and rank), rank gating, the differentiable sum and
    gather, and the OOM guard deciding over the ranks (``guard_case``)."""
    ranks, _ = two_ranks
    for rank, r in enumerate(ranks["init"]):
        assert (r["rank"], r["count"], r["main"]) == (rank, 2, rank == 0)
        assert r["sum"] == 6.0 * (1 + 2)
        # the backward all-reduces: every rank's block gets R x dL/dx
        assert torch.equal(r["grad"], torch.full((2, 3), 2.0))
        assert r["gathered"] == [0, 1]
        assert r["max"] == 11
        assert r["calls"] == [(8, 7), (4, 7)] and r["size"] == 8 and r["ok"]


def test_cli_train_distributed_over_two_ranks(tmp_path):
    """Two ranks of CLI ``train --distributed`` on the CPU: each loads its
    half of every global batch, the models stay equal across the ranks,
    and rank 0 writes the run's files."""
    import json

    from stylish_tts_tpu_torch.config import Config, dump_json
    from stylish_tts_tpu_torch.utils.synthetic import make_synthetic_dataset

    make_synthetic_dataset(tmp_path / "data", n_segments=8)
    (tmp_path / "model.json").write_text(dump_json(_tiny_config()))
    cfg = Config()
    cfg.dataset.path = str(tmp_path / "data")
    cfg.training_plan.acoustic.probe_batch_max = 2
    cfg.training.log_interval = 1
    cfg.training.val_interval = 1
    (tmp_path / "config.json").write_text(dump_json(cfg))
    ranks = join_ranks(start_ranks(["cli"], {"cli": {"root": str(tmp_path)}},
                                   tmp_path), ["cli"], tmp_path)["cli"]
    for r in ranks:
        assert r["differ"] == [] and r["joined"] is False
    stats = json.loads((tmp_path / "out" / "acoustic" /
                        "train_stats.json").read_text())
    assert stats["steps"] == 1 and len(stats["validations"]) == 1
    assert all(math.isfinite(e["loss"]) for e in stats["logs"])
    final = tmp_path / "out" / "acoustic" / "checkpoint_final"
    manifest = json.loads((final / "meta.json").read_text())["manifest"]
    # each rank's block is half of every global batch: the manifest counts
    # the global batches' audio, rank 0's stats its own rows
    audio_s = sum(2 * b[1] * b[3] for b in stats["batches"]) / 24000
    assert abs(manifest["total_trained_audio_seconds"] - audio_s) < 1e-6
    assert (tmp_path / "out" / "git_state.txt").is_file()


def test_two_rank_acoustic_step_equals_one_process(two_ranks):
    ranks, want = two_ranks
    want = want["acoustic"]
    assert {"mel", "generator", "discriminator"} <= set(want["metrics"])
    for r in ranks["acoustic"]:
        assert r["differ"] == []  # parameters equal across the ranks
        _assert_grads_close(r["grads"], want["grads"])
        _assert_metrics_close(r["metrics"], want["metrics"])
        assert abs(r["ema"] - want["ema"]) <= 1e-6 * abs(want["ema"])


def test_two_rank_alignment_step_and_epoch_end_equal_one_process(two_ranks):
    ranks, want = two_ranks
    want = want["alignment"]
    for r in ranks["alignment"]:
        assert r["differ"] == []
        _assert_grads_close(r["grads"], want["grads"])
        _assert_metrics_close(r["metrics"], want["metrics"])
        assert bool(r["priors"]["priors_initialized"])
        torch.testing.assert_close(r["priors"]["log_priors"],
                                   want["priors"]["log_priors"], rtol=0,
                                   atol=1e-6)
        # the batch norms' running stats: the global batch's moments
        for name, b in want["stats"].items():
            torch.testing.assert_close(r["stats"][name], b, rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("fail_after", [1, 0])
def test_an_oom_among_a_steps_collectives_stops_every_rank(tmp_path,
                                                          fail_after):
    """Rank 1 runs out of memory after its step's first collective (1) or
    before it (0), while rank 0 waits in the collective that rank 1 never
    joins.  Before the guard decided through the process group's store,
    rank 1's guard all-reduce paired with rank 0's second ``mesh.sum``:
    rank 0's gloo aborted its process on the size mismatch, and rank 1
    took the mis-paired result for an OOM vote and halved its batch alone.
    Now rank 1 posts to the store, waits 2 s for the others at the guard,
    records its verdict, aborts the group and raises; rank 0's pending
    collective fails as rank 1's process ends, rank 0 reads the verdict,
    and both ranks raise a ``RankFailure`` naming rank 1 far inside the
    group's 60 s timeout."""
    payload = {"midstep": {"fail_after": {1: fail_after}, "wait_s": 2.0}}
    ranks = join_ranks(start_ranks(["midstep"], payload, tmp_path,
                                   timeout_s=60.0),
                       ["midstep"], tmp_path, deadline_s=90.0)["midstep"]
    said = ("after 1 of the step's collectives" if fail_after
            else "before its step's first collective")
    for rank, r in enumerate(ranks):
        assert r.get("error") == "RankFailure", (rank, r)
        assert f"rank 1 ran out of memory {said}" in r["message"], \
            (rank, r["message"])
        assert r["seconds"] < 10.0, (rank, r["seconds"])
    # the token axis's padding (one max), then rank 0 waited in the sum
    # that rank 1 never issued
    assert [r["collectives"] for r in ranks] == [3 - (1 - fail_after),
                                                 2 - (1 - fail_after)]


@pytest.mark.parametrize("world", [2, 1])
def test_an_oom_after_the_same_collectives_on_every_rank_halves_together(
        tmp_path, world):
    """Every rank runs out of memory after its step's first ``mesh.sum``
    (the usual data-parallel OOM: the same shapes, the same collectives),
    over two ranks and over a world of one (``train --distributed`` in one
    process): the collectives paired up, so every rank restores, halves
    the global batch to 8 and retries, and the retry's two sums run."""
    payload = {"midstep": {"fail_after": {r: 1 for r in range(world)},
                           "wait_s": 2.0}}
    ranks = join_ranks(start_ranks(["midstep"], payload, tmp_path,
                                   timeout_s=60.0, world=world),
                       ["midstep"], tmp_path, deadline_s=90.0)["midstep"]
    assert len(ranks) == world
    for rank, r in enumerate(ranks):
        assert "error" not in r, (rank, r)
        assert r["returned"] == {"metrics": {"loss": 2.0 * world},
                                 "size": 8}, (rank, r)
        # the token axis's padding over two ranks, the failed step's sum
        # and the retry's two
        assert r["collectives"] == (world > 1) + 1 + 2, (rank, r)


@pytest.mark.parametrize("fail_after,want", [
    ({}, [1001, 1001]), ({0: 1, 1: 1}, [None, None]),
    ({1: 1}, "RankFailure")], ids=["none", "every-rank", "rank-1"])
def test_the_memory_probe_decides_an_oom_as_the_guard_does(tmp_path,
                                                          fail_after, want):
    """The memory probe over two ranks: the largest peak where no rank ran
    out of memory, None on both where both did after the same collective,
    and where rank 1 alone did after its probe step's first collective
    (rank 0 waiting in the second) a ``RankFailure`` naming rank 1 on both
    ranks, with no probe decision paired with a step collective."""
    payload = {"probe": {"fail_after": fail_after, "wait_s": 2.0}}
    ranks = join_ranks(start_ranks(["probe"], payload, tmp_path,
                                   timeout_s=60.0),
                       ["probe"], tmp_path, deadline_s=90.0)["probe"]
    if want == "RankFailure":
        for rank, r in enumerate(ranks):
            assert r.get("error") == "RankFailure", (rank, r)
            assert ("rank 1 ran out of memory after 1 of the step's "
                    "collectives (out of memory in the memory probe)"
                    in r["message"]), (rank, r["message"])
            assert r["seconds"] < 10.0, (rank, r["seconds"])
    else:
        assert [r.get("returned", r) for r in ranks] == want

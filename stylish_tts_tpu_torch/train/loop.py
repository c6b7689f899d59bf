"""Training driver: the four-stage chain acoustic -> textual -> style ->
duration, advancing on its own, the joint stage, which fine-tunes the
chain's text-to-speech path end to end and ends there, the alignment
stage, which trains the CTC aligner alone, and the three experimental
stages on frozen HuBERT and speaker nets, each alone (reference
train/train.py:76-449).

``train_model`` reads the dataset on disk, bootstraps the normalisation
stats, and for each stage plans its batch sizes (measured on the card,
``data/batch_manager.py:refine_plan``), steps through its epochs with the
OOM guard, validates every ``val_interval`` steps, saves every
``save_interval`` and at the stage's end, then moves to the next stage.

One train state holds every model of the chain on the device (71.97 M
parameters at the default config), so a module's Adam moments carry over
from one stage to the next and every checkpoint packages into an
artifact.  ``init_torch`` seeds the fresh state from a torch reference
checkpoint (``train/torch_seed.py``) before a ``checkpoint`` is loaded;
``slm.weights_path`` gives the frozen SLM converted WavLM weights.
The experimental stages' run holds their six models
(``EXPERIMENTAL_MODELS``), so one's checkpoint seeds another; their frozen
HuBERT and speaker nets come from ``hubert.weights_path`` and
``speaker_embedder.weights_path`` (else from the seed), and
``cfm_hubert_mel`` validates through Vocos where
``training.vocos_weights`` names its weights.  The frozen nets are never
saved.
Metrics stay on the device as tensors until the log interval,
then one stack and one copy reach the host: the loop adds no host sync of
its own to a step.

The alignment stage's run holds the aligner alone.  At each validation
interval it first trains on the val set (alignment is fitted to the data,
not generalised), at each epoch's end it sets the CTC label priors
(``end_alignment_epoch``), and at its end it writes the aligner's
parameters to ``<out>/alignment_model.safetensors``, the file that
``dataprep/align_text.py`` reads; the chain stops there.

``distributed=True`` trains data-parallel over processes (one per card;
``parallel/``): each loads its contiguous block of every global batch,
the losses and batch-norm moments are the global batch's, the gradients
are summed over the ranks, the parameters start equal (rank 0's,
broadcast and checked), the OOM guard decides collectively, and only rank
0 writes ``git_state.txt``, the logs' files, figures, statistics and
checkpoints.  A resumed run reads the checkpoint on every rank.

Each stage writes ``<out>/<stage>/train_stats.json``: the memory probe's
fit and seconds, each step's bin, rows and samples, each log window's wall
seconds and means (and the discriminator EMA), each validation's and
save's seconds, and what the guard's first-visit snapshots cost.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import time
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config, ModelConfig, dump_json
from ..data.batch_manager import BatchManager, step_memory
from ..data.dataset import FilePathDataset, get_data_path_list
from ..device import resolve_device
from ..models.text_aligner import aligner_params
from ..ops.mel import MelSpectrogram
from ..parallel import mesh
from ..parallel.multihost import (initialize_distributed, is_main_process,
                                  process_count, process_index,
                                  shutdown_distributed)
from ..text import TextCleaner
from ..utils.profiling import save_git_state
from ..utils.tensorfile import write_safetensors
from .checkpoint import (Manifest, NormalizationStats, checkpoint_name,
                         load_checkpoint, save_checkpoint)
from .init import build_train_state, init_slm, init_ssl, init_vocos
from .loss_log import combine_metrics, format_metrics
from .stages import (SSL_STAGES, StageContext, chain_models, check_stage,
                     end_alignment_epoch, make_eval_step, make_train_step)
from .state import TrainState, restore_state, snapshot_state
from .torch_seed import seed_state_from_torch

logger = logging.getLogger(__name__)

# every model of the chain: the state the loop trains and checkpoints
STATE_MODELS = chain_models("acoustic")
# every model of the experimental stages
EXPERIMENTAL_MODELS = list(dict.fromkeys(
    k for stage in SSL_STAGES for k in chain_models(stage)))
# the stages without the SLM perceptual loss
NO_SLM_STAGES = ("alignment", "cfm_hubert_pitch", "cfm_hubert_mel")


def state_models(stage_name: str) -> list:
    """The models of a run's state: the aligner alone for the alignment
    stage (its chain ends with it), the experimental stages' models for
    one of those, else every model of the four-stage chain."""
    if stage_name == "alignment":
        return chain_models("alignment")
    return EXPERIMENTAL_MODELS if stage_name in SSL_STAGES else STATE_MODELS


class TrainContext:
    """Host-side bundle of everything the loop touches."""

    def __init__(self, *, stage_name: str, out_dir: str, config: Config,
                 model_config: ModelConfig):
        self.config = config
        self.model_config = model_config
        self.base_out_dir = Path(out_dir)
        self.stage_name = stage_name
        self.out_dir = self.base_out_dir / stage_name
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.text_cleaner = TextCleaner(model_config.symbol)
        self.manifest = Manifest()
        self.normalization = NormalizationStats()
        self.writer = None  # tensorboardX SummaryWriter where it imports

        data_dir = Path(config.dataset.path)
        self.train_dataset, self.val_dataset = (
            FilePathDataset(
                data_list=get_data_path_list(data_dir / name),
                root_path=data_dir / config.dataset.wav_path,
                text_cleaner=self.text_cleaner, model_config=model_config,
                pitch_path=str(data_dir / config.dataset.pitch_path),
                alignment_path=str(data_dir / config.dataset.alignment_path))
            for name in (config.dataset.train_data, config.dataset.val_data))

    def init_normalization(self, device) -> None:
        """checkpoint -> json -> compute (reference
        train_context.py:191-331).  Every rank computes the same stats;
        rank 0 writes them."""
        norm_file = self.out_dir / "normalization.json"
        if self.normalization.frames == 0 and norm_file.is_file():
            for k, v in json.loads(norm_file.read_text()).items():
                setattr(self.normalization, k, v)
        if self.normalization.frames == 0:
            self.compute_normalization(device)
        if is_main_process():
            tmp = norm_file.with_suffix(".partial")
            tmp.write_text(json.dumps(asdict(self.normalization)))
            tmp.replace(norm_file)

    @torch.no_grad()
    def compute_normalization(self, device) -> None:
        """Log-mel mean and std over every train segment (f32 sums per
        segment on ``device``, accumulated in f64 on the host) and the
        dataset-wide log2-F0 mean and std of the voiced frames."""
        mc = self.model_config
        to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        total, total2, count = 0.0, 0.0, 0
        for i in range(len(self.train_dataset)):
            wave = self.train_dataset.load_item(i)["wave"]
            log_mel = torch.log(1e-5 + to_mel(
                torch.from_numpy(wave)[None].to(device)))
            sums = torch.stack([log_mel.sum(), (log_mel ** 2).sum()])
            s, s2 = sums.tolist()
            total += s
            total2 += s2
            count += log_mel.numel()
        if count > 0:
            mean = total / count
            var = (total2 - count * mean * mean) / max(count - 1, 1)
            self.normalization.mel_log_mean = float(mean)
            self.normalization.mel_log_std = float(np.sqrt(max(var, 1e-12)))
            self.normalization.frames = count
        voiced = [p[p > 0].ravel() for p in self.train_dataset.pitch.values()]
        if voiced:
            allf0 = np.log2(np.concatenate(voiced))
            self.normalization.f0_log2_mean = float(allf0.mean())
            self.normalization.f0_log2_std = float(allf0.std())


def select_val_samples(val_dataset, count: int) -> List[int]:
    """Deterministic sample selection by blake2b hash of the path
    (reference train/train.py:134-148)."""
    scored = [
        (hashlib.blake2b(seg.wav_path.encode(), digest_size=8).hexdigest(), i)
        for i, seg in enumerate(val_dataset.segments)
    ]
    return [i for _, i in sorted(scored)[:count]]


def _device_batch(batch: dict, device, rows: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """The batch's arrays (the first ``rows`` of each) as tensors on
    ``device``; the bin, paths and batch size stay on the host.  Over R
    ranks take the batch from ``_global_batch`` first."""
    return {k: torch.from_numpy(v if rows is None else v[:rows]).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def _global_batch(batch: dict, device) -> dict:
    """Over R ranks, ``batch`` with its token axis padded to the longest
    block's (a collective), so every rank holds its block at the global
    batch's shape; the batch itself in one process."""
    if mesh.world_size() > 1 and "text" in batch:
        return _pad_tokens(batch, mesh.max_int(batch["text"].shape[1],
                                               device))
    return batch


def _pad_tokens(batch: dict, tokens: int) -> dict:
    """``text`` and ``alignment`` zero-padded to ``tokens`` tokens."""
    pad = tokens - batch["text"].shape[1]
    if pad <= 0:
        return batch
    out = dict(batch)
    out["text"] = np.pad(batch["text"], ((0, 0), (0, pad)))
    if "alignment" in batch:
        out["alignment"] = np.pad(batch["alignment"],
                                  ((0, 0), (0, pad), (0, 0)))
    return out


def _shape_key(batch: dict, rows: int) -> tuple:
    """The shapes of the batch's arrays cut to their first ``rows``: what
    a step at that batch runs at (rows, tokens, frames, samples)."""
    return tuple((k, (min(rows, v.shape[0]),) + v.shape[1:])
                 for k, v in sorted(batch.items())
                 if isinstance(v, np.ndarray))


def _decide_oom(run):
    """Run ``run()``, one step that may issue ``mesh`` collectives, and
    take the OOM guard's decision common to the ranks after it
    (``mesh.oom_on_any_rank``, through the process group's store): (its
    result, None) where no rank ran out of memory, else (None, the
    message) on every rank, or ``mesh.RankFailure`` raised on every rank
    where they cannot restore together.  A collective released by the
    abort of a rank that failed raises that rank's ``RankFailure``."""
    issued = mesh.collective_count()
    out, message = None, None
    try:
        out = run()
    except torch.cuda.OutOfMemoryError as exc:
        message = str(exc)[:160]
    except RuntimeError as exc:
        failure = mesh.rank_failure()
        if failure is not None:
            raise failure from exc
        raise
    if mesh.oom_on_any_rank(message, mesh.collective_count() - issued):
        return None, message or "out of memory on another rank"
    return out, None


def _guarded_step(step_fn, state: TrainState, batch: dict, generator, bm,
                  device, skip_bins: set, validated: Optional[set] = None,
                  record: Optional[dict] = None):
    """One train step with the reference's OOM resilience
    (train/batch_manager.py:187-242): on ``torch.cuda.OutOfMemoryError``
    the bin's batch size is halved and persisted and the batch, cut to the
    new size, retried; after 3 failures the bin is skipped for the epoch.

    The first time each set of shapes runs (``_shape_key``; ``validated``
    tracks them, so a new text bucket or a partial last batch counts) the
    state and the generator are snapshotted to the host first, so an OOM
    part way through the step (after a spectral-norm vector or a first
    moment was written) restores them exactly.  Before a retry the
    failed step's tensors are dropped, every gradient cleared and the
    allocator's cache emptied.  ``record`` counts the snapshots and their
    seconds.  Other errors raise.  Returns (state, metrics or None).

    Over R ranks the decision is common (``_decide_oom``): every rank
    restores and halves together (the batch sizes are global, each rank
    keeps its share of the rows) when every rank reached the decision
    having issued the same collectives, as where every rank ran out of
    memory at the same point, or before any collective, or where the
    world is one.  A rank that runs out of memory where another still
    waits in a collective it never joins, or after other collectives than
    the others issued, stops the run instead: every rank raises
    ``mesh.RankFailure`` naming it."""
    bin_num = batch.get("bin")
    rows = batch["text"].shape[0]
    batch = _global_batch(batch, device)
    oom_tries = 0
    while oom_tries < 3:
        key = _shape_key(batch, rows)
        first_run = validated is not None and key not in validated
        snapshot = None
        if first_run:
            t0 = time.perf_counter()
            snapshot = snapshot_state(state, generator)
            if record is not None:
                record["snapshots"] += 1
                record["snapshot_s"] += time.perf_counter() - t0
        out, message = _decide_oom(lambda: step_fn(
            state, _device_batch(batch, device, rows), generator))
        if message is None:
            if first_run:
                validated.add(key)
            return out
        # out of the handler: the failed step's tensors are free now
        if snapshot is not None:
            restore_state(state, snapshot, generator)
        for optimizer in state.optimizers.values():
            optimizer.zero_grad(set_to_none=True)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        if record is not None:
            record["oom"] += 1
        oom_tries += 1
        cur = bm.get_batch_size(bin_num)
        new_bs = max(bm.divisor, cur // 2 // bm.divisor * bm.divisor)
        if new_bs >= cur:
            break
        bm.set_batch_size(bin_num, new_bs)
        rows = max(1, new_bs // mesh.world_size())
        logger.warning("OOM on bin %s (%s): batch size %d -> %d (persisted), "
                       "retrying", bin_num, message, cur, new_bs)
    skip_bins.add(bin_num)
    logger.warning("bin %s OOMs at minimum batch; skipping this epoch",
                   bin_num)
    return state, None


def _drain_metrics(logs: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over the logged steps, with one stack on
    the device and one copy to the host.  Inconsistent metric keys raise."""
    if not logs:
        return {}
    names = sorted(logs[0].keys())
    block = torch.stack([torch.stack([m[k] for k in names]) for m in logs])
    return dict(zip(names, block.mean(dim=0).tolist()))


def _summary_writer(path: Path):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(str(path / "tensorboard"))


def _stage_stats() -> dict:
    return {"probe": None, "logs": [], "validations": [], "saves": [],
            "batches": [],  # [bin, rows, tokens, samples] of each step
            "guard": {"snapshots": 0, "snapshot_s": 0.0, "oom": 0},
            "first_visits": 0, "steps": 0, "seconds": 0.0}


def train_model(
    *,
    config: Config,
    model_config: ModelConfig,
    out_dir: str,
    stage_name: str = "acoustic",
    checkpoint: Optional[str] = None,
    init_torch: Optional[str] = None,
    max_steps: Optional[int] = None,
    reset_stage: bool = False,
    workers: int = 8,
    device=None,
    seed: int = 0,
    on_stage: Optional[Callable[[str, str, TrainState], None]] = None,
    distributed: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Manifest:
    """Train from ``stage_name`` to the end of the chain; returns the final
    manifest.  ``device`` defaults to the card.  ``seed`` draws the
    models (a CPU generator, so a run starts from the same weights on any
    device), the frozen SLM and the run's device generator (dropout,
    latent and harmonic-prior noise), which checkpoints carry.
    ``init_torch`` names a torch reference checkpoint directory
    (``accelerator.save_state``) whose converted weights replace the drawn
    ones of every model it holds and the state runs.
    ``on_stage(event, stage, state)`` is called at each stage's "start",
    after its memory plan ("planned") and after its final save ("end").
    ``distributed`` joins the process group (``coordinator``,
    ``num_processes`` and ``process_id``, or torchrun's environment) and
    trains data-parallel on this process's card (``cuda:LOCAL_RANK``), or
    on the CPU under gloo; rank r > 0 draws its noise from ``seed`` + r
    x 1000003."""
    started_group = False
    if distributed:
        started_group = not torch.distributed.is_initialized()
        device = initialize_distributed(coordinator, num_processes,
                                        process_id, device=device)
    device = resolve_device(device)
    rank, world = process_index(), process_count()
    check_stage(stage_name)
    ctx = TrainContext(stage_name=stage_name, out_dir=out_dir, config=config,
                       model_config=model_config)
    if is_main_process():
        save_git_state(ctx.base_out_dir)
        ctx.writer = _summary_writer(ctx.out_dir)
    state = build_train_state(model_config, state_models(stage_name),
                              device=device,
                              generator=torch.Generator().manual_seed(seed))
    slm = ssl = vocos = None
    if stage_name not in NO_SLM_STAGES:
        slm = init_slm(model_config,
                       torch.Generator().manual_seed(seed + 7)).to(device)
        if not model_config.slm.weights_path:
            logger.warning(
                "slm.weights_path is unset: the SLM perceptual loss runs on "
                "random WavLM features drawn from the seed; set it to a "
                "converted WavLM file for the reference's quality")
    if stage_name in SSL_STAGES:
        ssl = tuple(m.to(device) for m in init_ssl(
            model_config, torch.Generator().manual_seed(seed + 11)))
        for name, path in (("hubert", model_config.hubert.weights_path),
                           ("speaker_embedder",
                            model_config.speaker_embedder.weights_path)):
            if not path:
                logger.warning("%s.weights_path is unset: the frozen net "
                               "is drawn from the seed", name)
    if stage_name == "cfm_hubert_mel":
        vocos = init_vocos(config.training.vocos_weights)
        vocos = vocos.to(device) if vocos is not None else None
    if init_torch:
        seed_state_from_torch(state, init_torch)
    generator = torch.Generator(device=device).manual_seed(seed)
    if checkpoint:
        _, ctx.manifest, ctx.normalization, _ = load_checkpoint(
            checkpoint, state, generator)
        logger.info("restored checkpoint %s", checkpoint)
        if reset_stage:
            ctx.manifest.current_step = 0
            ctx.manifest.current_epoch = 0
            ctx.manifest.stage = ""
    if rank:
        # the checkpoint holds rank 0's generator; the others draw apart
        generator.manual_seed(seed + 1000003 * rank
                              + ctx.manifest.current_total_step)
    if world > 1:
        modules = list(state.models.values())
        mesh.broadcast_modules(modules)
        differ = mesh.check_equal(modules)
        if differ:
            raise RuntimeError(f"parameters differ between the ranks after "
                               f"the broadcast: {differ[:5]}")

    current: Optional[str] = stage_name
    while current is not None:
        stage = check_stage(current)
        started = time.perf_counter()
        stats = _stage_stats()
        if on_stage:
            on_stage("start", current, state)
        ctx.stage_name = current
        ctx.out_dir = ctx.base_out_dir / current
        ctx.out_dir.mkdir(parents=True, exist_ok=True)
        plan = getattr(config.training_plan, current)
        shards = dict(divisor=world, process_index=rank,
                      process_count=world)
        bm = BatchManager(
            ctx.train_dataset, ctx.out_dir, current,
            probe_batch_max=plan.probe_batch_max, num_workers=workers,
            **shards)
        ctx.init_normalization(device)
        steps_per_epoch = bm.steps_per_epoch()
        ctx.manifest.steps_per_epoch = steps_per_epoch
        stage_ctx = StageContext(
            model_config=model_config, config=config,
            mel_mean=ctx.normalization.mel_log_mean,
            mel_std=ctx.normalization.mel_log_std,
            step_limit=max(steps_per_epoch * plan.epochs, 1), slm=slm,
            duration_class_weight=torch.as_tensor(
                ctx.train_dataset.duration_weights, device=device),
            ssl=ssl, vocos=vocos,
            f0_log2_mean=ctx.normalization.f0_log2_mean,
            f0_log2_std=ctx.normalization.f0_log2_std)
        if config.training.aot_memory_plan and bm.freshly_planned:
            stats["probe"] = _plan_memory(bm, stage_ctx, state, plan, current,
                                          config, model_config, device)
            steps_per_epoch = bm.steps_per_epoch()
            stage_ctx.step_limit = max(steps_per_epoch * plan.epochs, 1)
            ctx.manifest.steps_per_epoch = steps_per_epoch
        if on_stage:
            on_stage("planned", current, state)
        step_fn = make_train_step(current, stage_ctx, plan.lr)
        eval_fn = make_eval_step(current, stage_ctx)
        val_manager = BatchManager(
            ctx.val_dataset, ctx.out_dir, current,
            probe_batch_max=plan.probe_batch_max, num_workers=workers,
            **shards)
        val_samples = select_val_samples(ctx.val_dataset,
                                         config.validation.sample_count)

        # the stage-local step drives the cosine LR; resume mid-stage goes
        # on from the saved step, and from the batch the epoch was at
        resuming = bool(checkpoint) and ctx.manifest.stage == current
        stage_step = ctx.manifest.current_step if resuming else 0
        state.step = stage_step
        start_epoch = stage_step // max(steps_per_epoch, 1) if resuming else 0
        resume_skip = stage_step % max(steps_per_epoch, 1) if resuming else 0
        ctx.manifest.stage = current
        logs: List[Dict[str, torch.Tensor]] = []
        done = False
        validated: set = set()
        window = {"t": time.perf_counter(), "steps": 0, "first": 0}
        for epoch in range(start_epoch, plan.epochs):
            ctx.manifest.current_epoch = epoch + 1
            skip_bins: set = set()
            iterator = bm.epoch_iterator(
                stage=current, epoch=epoch + 1,
                skip_batches=resume_skip if epoch == start_epoch else 0)
            for batch in iterator:
                if batch.get("bin") in skip_bins:
                    continue
                seen = len(validated)
                state, metrics = _guarded_step(
                    step_fn, state, batch, generator, bm, device, skip_bins,
                    validated=validated, record=stats["guard"])
                if metrics is None:  # bin skipped after repeated OOM
                    continue
                window["steps"] += 1
                window["first"] += len(validated) > seen
                stats["steps"] += 1
                stats["batches"].append([int(batch["bin"]),
                                         *map(int, batch["text"].shape),
                                         int(batch["audio_gt"].shape[1])])
                ctx.manifest.current_step += 1
                ctx.manifest.current_total_step += 1
                ctx.manifest.total_trained_audio_seconds += (
                    batch["global_batch_size"] * batch["audio_gt"].shape[1]
                    / model_config.sample_rate)
                logs.append(metrics)
                step = ctx.manifest.current_total_step
                if step % config.training.log_interval == 0:
                    combined = _drain_metrics(logs)
                    logs = []
                    _log_window(ctx, stats, window, state, combined, current,
                                step, stage.discriminators)
                if step % config.training.val_interval == 0:
                    if current == "alignment":
                        _train_on_val(state, step_fn, val_manager, current,
                                      epoch, generator, device)
                    _validate(ctx, state, eval_fn, val_manager, current,
                              val_samples, device, stats)
                    window["t"] = time.perf_counter()
                if step % config.training.save_interval == 0:
                    _save(ctx, state, config, model_config, generator, stats)
                    window["t"] = time.perf_counter()
                if max_steps and ctx.manifest.current_total_step >= max_steps:
                    done = True
                    break
            iterator.close()
            if stage.uses_priors:
                end_alignment_epoch(state)
            if done:
                break

        if current == "alignment" and is_main_process():
            write_safetensors(ctx.base_out_dir / "alignment_model.safetensors",
                              aligner_params(state.models["text_aligner"]))
        _save(ctx, state, config, model_config, generator, stats, final=True)
        stats["first_visits"] = len(validated)
        stats["seconds"] = time.perf_counter() - started
        if is_main_process():
            (ctx.out_dir / "train_stats.json").write_text(json.dumps(stats))
        if on_stage:
            on_stage("end", current, state)
        logger.info("[%s] stage done in %.1f s: %d steps, %d first visits "
                    "(snapshots %.2f s), %d OOM", current, stats["seconds"],
                    stats["steps"], len(validated),
                    stats["guard"]["snapshot_s"], stats["guard"]["oom"])
        if done:
            break
        current = stage.next_stage
        ctx.manifest.current_step = 0
        ctx.manifest.current_epoch = 0
    if started_group:
        shutdown_distributed()
    return ctx.manifest


def _train_on_val(state: TrainState, step_fn, val_manager: BatchManager,
                  stage: str, epoch: int, generator, device) -> None:
    """One train step on each val batch, in order and without jitter (the
    alignment stage's validation interval, reference train.py:397-403);
    the manifest's counters do not move."""
    for batch in val_manager.epoch_iterator(stage=stage, epoch=epoch + 1,
                                            shuffle=False, jitter=False):
        step_fn(state, _device_batch(_global_batch(batch, device), device),
                generator)


def _probe_on_ranks(measure, device, batch: int,
                    bin_num: int) -> Optional[int]:
    """``measure(batch, bin_num)`` (``step_memory``'s probe, None where its
    step ran out of memory) on every rank, each on its own rows: the
    largest peak over the ranks, or None on every rank where one ran out
    of memory.  The probe's step issues the step's collectives, so the
    OOM is decided as the guard decides it (``_decide_oom``)."""

    def probe() -> int:
        peak = measure(batch, bin_num)
        if peak is None:
            raise torch.cuda.OutOfMemoryError("out of memory in the memory "
                                              "probe")
        return peak

    peak, message = _decide_oom(probe)
    return None if message else mesh.max_int(peak, device)


def _plan_memory(bm: BatchManager, stage_ctx: StageContext,
                 state: TrainState, plan, current: str, config: Config,
                 model_config: ModelConfig, device) -> dict:
    """Refine the stage's heuristic plan from steps measured on the card;
    on the CPU there is no device memory to measure, so the heuristic
    plan stays."""
    if device.type != "cuda":
        logger.info("[%s] no device memory to measure on %s: keeping the "
                    "heuristic batch plan", current, device)
        return {"kept": f"no device memory to measure on {device}"}
    t0 = time.perf_counter()
    measure = step_memory(make_train_step(current, stage_ctx, plan.lr),
                          state, model_config, check_stage(current).inputs,
                          device)

    fit = bm.refine_plan(
        functools.partial(_probe_on_ranks, measure, device),
        budget_bytes=config.training.memory_budget_mib * 2**20,
        scale=bm.process_count)
    return {"seconds": time.perf_counter() - t0, **fit,
            "batch_sizes": dict(bm.batch_sizes)}


def _log_window(ctx, stats, window, state, combined, current, step,
                discriminators) -> None:
    """Log one drained window: its means, its wall seconds per step
    (the drain has synced, so no further wait) and the discriminator
    EMA."""
    now = time.perf_counter()
    total = combined.pop("loss", 0.0)
    entry = {"step": step, "stage_step": ctx.manifest.current_step,
             "steps": window["steps"], "first_visits": window["first"],
             "seconds": now - window["t"], "loss": total,
             "metrics": combined}
    if discriminators:
        entry["disc_ema"] = {k: state.disc_ema[k].item()
                             for k in discriminators}
    stats["logs"].append(entry)
    window.update(t=now, steps=0, first=0)
    logger.info("[%s] epoch %d step %d %s", current,
                ctx.manifest.current_epoch, step,
                format_metrics(combined, total))
    if ctx.writer:
        ctx.writer.add_scalar("train/loss", total, step)
        for k, v in combined.items():
            ctx.writer.add_scalar(f"train/{k}", v, step)


def _validate(ctx: TrainContext, state: TrainState, eval_fn,
              val_manager: BatchManager, stage: str, val_samples, device,
              stats: dict) -> None:
    """The eval step over the val set: metrics logged, ``best_loss`` kept,
    and for the deterministic sample set the audio (and figures, where
    matplotlib imports) written to TensorBoard.  The speech predictor's
    noise comes from a generator seeded by the step, so validation leaves
    the run's generator where it was."""
    t0 = time.perf_counter()
    logs = []
    samples_written = 0
    step = ctx.manifest.current_total_step
    generator = torch.Generator(device=device).manual_seed(step)
    for batch in val_manager.epoch_iterator(stage=stage, epoch=0,
                                            shuffle=False, jitter=False):
        device_batch = _device_batch(_global_batch(batch, device), device)
        metrics, audio_pred = eval_fn(state, device_batch, generator)
        logs.append({k: float(v) for k, v in metrics.items()})
        if (ctx.writer is not None and audio_pred is not None
                and samples_written < len(val_samples)):
            _write_sample(ctx, samples_written, step, audio_pred,
                          device_batch)
            samples_written += 1
    combined = combine_metrics(logs)
    total = combined.pop("loss", 0.0)
    logger.info("Validation step %d: %s", step,
                format_metrics(combined, total))
    if total < ctx.manifest.best_loss:
        ctx.manifest.best_loss = total
    if ctx.writer is not None:
        ctx.writer.add_scalar("eval/loss", total, step)
        for k, v in combined.items():
            ctx.writer.add_scalar(f"eval/{k}", v, step)
    stats["validations"].append({"step": step, "loss": total,
                                 "metrics": combined,
                                 "seconds": time.perf_counter() - t0})


def _write_sample(ctx, index: int, step: int, audio_pred, batch) -> None:
    """One validation sample's audio and figures in TensorBoard; a
    missing writer dependency (soundfile, matplotlib) logs a warning."""
    try:
        ctx.writer.add_audio(f"eval/sample_{index}",
                             audio_pred[0].float().cpu().numpy(), step,
                             sample_rate=ctx.model_config.sample_rate)
        from ..utils.figures import (plot_attention, plot_mel_difference,
                                     plot_spectrogram)

        mc = ctx.model_config
        to_mel = MelSpectrogram(
            n_mels=mc.n_mels, n_fft=mc.n_fft, win_length=mc.win_length,
            hop_length=mc.hop_length, sample_rate=mc.sample_rate)
        with torch.no_grad():
            mel_pred = torch.log(torch.clamp(to_mel(audio_pred[:1].float()),
                                             min=1e-5))[0].cpu().numpy()
            mel_gt = torch.log(torch.clamp(to_mel(batch["audio_gt"][:1]),
                                           min=1e-5))[0].cpu().numpy()
        norm = ctx.normalization
        ctx.writer.add_figure(
            f"eval/sample_{index}/mel",
            plot_spectrogram(mel_pred, f"Predicted Mel (Step {step})"), step)
        ctx.writer.add_figure(
            f"eval/sample_{index}/mel_difference",
            plot_mel_difference((mel_gt - norm.mel_log_mean)
                                / norm.mel_log_std, mel_pred,
                                norm.mel_log_mean, norm.mel_log_std), step)
        ctx.writer.add_figure(
            f"eval/attention_{index}",
            plot_attention(batch["alignment"][0].cpu().numpy()), step)
    except Exception as exc:  # samples must never stop validation
        logger.warning("sample logging failed: %s", exc)


def _save(ctx: TrainContext, state: TrainState, config: Config,
          model_config: ModelConfig, generator, stats: dict,
          final: bool = False) -> None:
    if not is_main_process():
        return
    name = ("checkpoint_final" if final else checkpoint_name(
        ctx.manifest.current_epoch, ctx.manifest.current_total_step))
    t0 = time.perf_counter()
    save_checkpoint(ctx.out_dir, name, state, ctx.manifest,
                    ctx.normalization, dump_json(config),
                    dump_json(model_config), generator=generator)
    stats["saves"].append({"name": name,
                           "step": ctx.manifest.current_total_step,
                           "seconds": time.perf_counter() - t0})
    logger.info("saved %s", ctx.out_dir / name)

"""BatchManager: owns the training dataset, per-bin batch sizes and the
prefetching epoch iterator.

Batch sizes come from an inverse-linear memory plan (activation memory
grows about linearly with frames × batch, so a bin's batch size scales
with the frame ratio to a reference bin, clamped), and stay JSON-persisted
in ``<stage>_batch_sizes.json``, hot-reloadable between batches, so an
operator can still edit them live (reference train/dataloader.py:377,
train/stage.py:71-83).  Batches are numpy; the caller moves them to the
device.

The JAX package refines the plan ahead of time from XLA's compiled memory
analysis (``refine_plan_aot``).  Here ``refine_plan`` keeps its algorithm
(two probes, an affine fit, a per-bin solve, validation at the largest and
smallest bins) on a ``measure(batch, bin)`` callable; ``step_memory``
gives the measured one: the peak device bytes of one real train step on a
synthetic batch of that shape, the state restored afterwards.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from .collate import collate
from .dataset import FilePathDataset, get_frame_count
from .sampler import DynamicBatchSampler

logger = logging.getLogger(__name__)

# share of the memory budget the measured plan solves each bin against
# (the JAX package's ``refine_plan_aot`` margin)
PLAN_MARGIN = 0.92


class BatchManager:
    def __init__(
        self,
        dataset: FilePathDataset,
        out_dir: str | Path,
        stage_name: str,
        *,
        probe_batch_max: int = 32,
        num_workers: int = 8,
        divisor: int = 1,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.out_dir = Path(out_dir)
        self.stage_name = stage_name
        self.probe_batch_max = probe_batch_max
        self.num_workers = num_workers
        # every (global) batch is a multiple of `divisor` (the
        # data-parallel width), so its rows split evenly; each process
        # loads only its contiguous 1/process_count block of it
        self.divisor = max(1, divisor)
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.time_bins, self.seconds_per_bin = dataset.time_bins()
        self.batch_sizes: Dict[str, int] = {}
        # set when no persisted plan existed and the heuristic one was
        # made: the signal that a measured refinement is worthwhile
        self.freshly_planned = False
        self.load_batch_sizes()
        if not self.batch_sizes:
            self.plan_batch_sizes()
            self.freshly_planned = True

    # -- batch-size planning / persistence -------------------------------- #

    def batch_file(self) -> Path:
        return self.out_dir / f"{self.stage_name}_batch_sizes.json"

    def load_batch_sizes(self) -> None:
        path = self.batch_file()
        if path.is_file():
            self.batch_sizes = json.loads(path.read_text())

    def save_batch_sizes(self) -> None:
        """Persist the plan (process 0 only; a write and a rename, so a
        process reading it meanwhile finds the old file or the new one)."""
        if self.process_index != 0:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.batch_file().with_suffix(".partial")
        tmp.write_text(json.dumps(self.batch_sizes))
        tmp.replace(self.batch_file())

    def plan_batch_sizes(self, reference_bin: int = 20) -> None:
        """Inverse-linear memory plan: bin `reference_bin` (~7 s audio)
        gets probe_batch_max; other bins scale by frame ratio."""
        ref_frames = get_frame_count(reference_bin)
        for bin_num in self.time_bins:
            frames = get_frame_count(bin_num)
            bs = max(1, int(self.probe_batch_max * ref_frames / frames))
            self.batch_sizes[str(bin_num)] = min(bs, self.probe_batch_max * 4)
        self.save_batch_sizes()

    def refine_plan(
        self,
        measure: Callable[[int, int], Optional[int]],
        *,
        budget_bytes: int,
        probe_batch: int = 8,
        scale: int = 1,
    ) -> dict:
        """Replace the heuristic plan by one solved from measured bytes.
        ``measure(batch, bin)`` gives the peak bytes of a step at that
        batch size and bin, or None where it ran out of memory (over the
        budget).

          1. two probes at ``probe_batch`` (largest and middle bin) fit
             total(b, f) = fixed + c * b * f;
          2. every bin is solved against ``PLAN_MARGIN * budget_bytes``;
          3. the chosen sizes of the largest and the smallest bin are
             measured and shrunk until they fit.

        The plan is kept where a probe runs out of memory, the fit is
        degenerate or the fixed part alone exceeds the budget.  The probe
        measures one process's (one card's) rows: the stored, global sizes
        are the solved ones times ``scale``, the data-parallel width.
        Sizes are at least ``divisor`` and are persisted.  Returns
        ``kept`` (None, or why the plan was kept), the ``measured``
        (batch, bin, bytes) triples and, where solved, the fit's ``fixed``
        and ``per_sample_frame`` bytes."""
        bins = sorted(self.time_bins)
        largest, mid = bins[-1], bins[len(bins) // 2]
        f_large, f_mid = get_frame_count(largest), get_frame_count(mid)
        measured = []

        def kept(reason: str) -> dict:
            logger.warning("memory probe: %s; keeping the plan", reason)
            return {"kept": reason, "measured": measured}

        for bin_num in (largest, mid):
            measured.append((probe_batch, bin_num,
                             measure(probe_batch, bin_num)))
            if measured[-1][2] is None:
                return kept(f"out of memory at batch {probe_batch}")
        y_large, y_mid = measured[0][2], measured[1][2]
        if f_large <= f_mid or y_large <= y_mid:
            return kept("degenerate fit (the bytes do not grow with the "
                        "frames)")
        per_sample_frame = (y_large - y_mid) / (probe_batch
                                                * (f_large - f_mid))
        fixed = y_large - per_sample_frame * probe_batch * f_large
        usable = budget_bytes * PLAN_MARGIN - fixed
        if usable <= 0:
            return kept("the fixed state exceeds the budget")
        for bin_num in bins:
            f = get_frame_count(bin_num)
            bs = int(usable / (per_sample_frame * f))
            self.batch_sizes[str(bin_num)] = max(1, min(bs, 256))

        for bin_num in (largest, bins[0]):
            bs = self.batch_sizes[str(bin_num)]
            for _ in range(4):
                if bs <= 1:
                    break
                y = measure(bs, bin_num)
                measured.append((bs, bin_num, y))
                if y is None:  # out of memory
                    bs = max(1, bs * 3 // 4)
                    continue
                if y <= budget_bytes:
                    break
                bs = max(1, int(bs * budget_bytes * PLAN_MARGIN / y))
            self.batch_sizes[str(bin_num)] = bs

        for key in self.batch_sizes:
            self.batch_sizes[key] = max(self.divisor,
                                        self.batch_sizes[key] * scale)
        self.save_batch_sizes()
        logger.info("measured memory plan: fixed %.0f MiB, %.0f B per "
                    "sample-frame, largest-bin batch %s", fixed / 2**20,
                    per_sample_frame, self.batch_sizes[str(largest)])
        return {"kept": None, "fixed": fixed,
                "per_sample_frame": per_sample_frame, "measured": measured}

    def get_batch_size(self, bin_num: int) -> int:
        bs = int(self.batch_sizes.get(str(bin_num), 1))
        if self.divisor > 1:
            # global batches split evenly over the data-parallel width;
            # small bins round UP (the iterator wrap-pads short batches)
            bs = max(self.divisor, bs // self.divisor * self.divisor)
        return bs

    def set_batch_size(self, bin_num: int, batch_size: int) -> None:
        self.batch_sizes[str(bin_num)] = batch_size
        self.save_batch_sizes()

    def steps_per_epoch(self) -> int:
        total = 0
        for key, idxs in self.time_bins.items():
            bs = self.get_batch_size(key)
            if bs > 0:
                total += -(-len(idxs) // bs)  # ceil
        return total

    # -- epoch iteration --------------------------------------------------- #

    def epoch_iterator(
        self,
        *,
        stage: str,
        epoch: int,
        seed: int = 0,
        shuffle: bool = True,
        jitter: bool = True,
        skip_batches: int = 0,
    ) -> Iterator[dict]:
        """Yields collated numpy batches, decoding audio on a thread pool
        and prefetching up to four batches ahead of the device step.
        Closing the iterator early stops and joins its threads."""
        sampler = DynamicBatchSampler(
            self.time_bins,
            self.get_batch_size,
            shuffle=shuffle,
            seed=seed,
            epoch=epoch,
        )
        # the jitter rng is seeded per (epoch, batch index), not drawn from
        # one stream: a resumed epoch must produce the exact batches the
        # uninterrupted run would have (skipping plan entries must not
        # shift the jitter stream)
        epoch_seed = seed * 100003 + epoch
        plan = list(enumerate(sampler))
        if skip_batches:
            plan = plan[skip_batches:]

        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_index, (bin_num, idxs) in plan:
                        if stop.is_set():
                            break
                        # wrap-pad so the batch splits evenly over the
                        # data-parallel width (the reference runs
                        # even_batches=False; a short batch is padded by
                        # cycling it instead of dropped)
                        if len(idxs) % self.divisor:
                            need = -(-len(idxs) // self.divisor) * self.divisor
                            reps = -(-need // len(idxs))
                            idxs = (list(idxs) * reps)[:need]
                        # this process's contiguous block of the batch
                        per = len(idxs) // self.process_count
                        local = idxs[self.process_index * per:
                                     (self.process_index + 1) * per]
                        items = list(pool.map(self.dataset.load_item, local))
                        batch = collate(
                            items, stage=stage,
                            rng=np.random.default_rng(
                                epoch_seed * 1000003 + batch_index
                            ),
                            jitter=jitter,
                        )
                        batch["bin"] = bin_num
                        batch["global_batch_size"] = len(idxs)
                        q.put(batch)
            except Exception as exc:  # propagate to consumer
                q.put(exc)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early: drain so the producer, blocked
            # on a full queue, sees the stop and ends with its pool
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass


def probe_batch_arrays(model_config, batch: int, bin_num: int,
                       inputs: List[str], seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """A synthetic batch of ``batch`` rows at bin ``bin_num``, with the
    shapes the JAX package's ahead-of-time probe compiles: the bin's frames,
    ``max(32, min(512, frames * 192 // 460))`` tokens, a one-hot alignment
    that spreads the tokens evenly over the frames, a 150 Hz pitch and a
    quiet noise signal.  Only the keys in ``inputs``."""
    frames = get_frame_count(bin_num)
    tokens = max(32, min(512, frames * 192 // 460))
    rng = np.random.default_rng(seed)
    owner = np.arange(frames) * tokens // frames
    alignment = np.zeros((batch, tokens, frames), np.float32)
    alignment[:, owner, np.arange(frames)] = 1.0
    arrays = dict(
        text=rng.integers(1, model_config.text_encoder.tokens,
                          (batch, tokens)).astype(np.int32),
        text_length=np.full(batch, tokens, np.int32),
        alignment=alignment,
        pitch=np.full((batch, frames), 150.0, np.float32),
        audio_gt=(0.1 * rng.standard_normal(
            (batch, frames * model_config.hop_length))).astype(np.float32),
    )
    return {k: arrays[k] for k in inputs if k in arrays}


def step_memory(step_fn, state, model_config, inputs: List[str], device,
                seed: int = 0) -> Callable[[int, int], Optional[int]]:
    """``measure(batch, bin)`` for ``refine_plan`` on the card: the peak of
    ``torch.cuda.max_memory_allocated`` over one real ``step_fn`` on a
    synthetic batch of that shape (``probe_batch_arrays``), or None where
    the step raised ``torch.cuda.OutOfMemoryError``.  The state is
    snapshotted to the host before and restored after, so parameters,
    moments (dropped where the probe created them), batch stats, the EMA
    and the step are left as they were; the probe draws from a generator
    of its own."""
    import torch

    from ..train.state import restore_state, snapshot_state

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the memory probe measures the card's memory; "
                           f"it cannot run on {device}")

    def measure(batch: int, bin_num: int) -> Optional[int]:
        tensors = {k: torch.from_numpy(v).to(device) for k, v in
                   probe_batch_arrays(model_config, batch, bin_num,
                                      inputs, seed).items()}
        snapshot = snapshot_state(state)
        generator = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        peak = None
        try:
            step_fn(state, tensors, generator)
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        except torch.cuda.OutOfMemoryError:
            pass
        # out of the handler: the failed step's tensors are free again
        del tensors
        restore_state(state, snapshot)
        torch.cuda.empty_cache()
        logger.info("memory probe: batch %d at bin %d: %s", batch, bin_num,
                    "out of memory" if peak is None else f"{peak} bytes")
        return peak

    return measure

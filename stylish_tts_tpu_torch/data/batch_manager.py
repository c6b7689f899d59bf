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
analysis (``refine_plan_aot``).  Its torch form, an out-of-memory probe
per bin, belongs with the training loop and is not here.
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

from .collate import collate
from .dataset import FilePathDataset, get_frame_count
from .sampler import DynamicBatchSampler


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
    ):
        self.dataset = dataset
        self.out_dir = Path(out_dir)
        self.stage_name = stage_name
        self.probe_batch_max = probe_batch_max
        self.num_workers = num_workers
        # every batch is a multiple of `divisor` (the data-parallel width),
        # so its rows split evenly
        self.divisor = max(1, divisor)
        self.time_bins, self.seconds_per_bin = dataset.time_bins()
        self.batch_sizes: Dict[str, int] = {}
        self.load_batch_sizes()
        if not self.batch_sizes:
            self.plan_batch_sizes()

    # -- batch-size planning / persistence -------------------------------- #

    def batch_file(self) -> Path:
        return self.out_dir / f"{self.stage_name}_batch_sizes.json"

    def load_batch_sizes(self) -> None:
        path = self.batch_file()
        if path.is_file():
            self.batch_sizes = json.loads(path.read_text())

    def save_batch_sizes(self) -> None:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.batch_file().write_text(json.dumps(self.batch_sizes))

    def plan_batch_sizes(self, reference_bin: int = 20) -> None:
        """Inverse-linear memory plan: bin `reference_bin` (~7 s audio)
        gets probe_batch_max; other bins scale by frame ratio."""
        ref_frames = get_frame_count(reference_bin)
        for bin_num in self.time_bins:
            frames = get_frame_count(bin_num)
            bs = max(1, int(self.probe_batch_max * ref_frames / frames))
            self.batch_sizes[str(bin_num)] = min(bs, self.probe_batch_max * 4)
        self.save_batch_sizes()

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
                        items = list(pool.map(self.dataset.load_item, idxs))
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

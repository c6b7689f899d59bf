"""Bucketed dynamic batch sampler.

Parity with DynamicBatchSampler (train/dataloader.py:300-406): batches are
drawn bucket-by-bucket with per-bin batch sizes, bin order is
weighted-random by remaining batch count, shuffling is epoch-seeded, and
batch sizes can be hot-reloaded between batches via a callback.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


class DynamicBatchSampler:
    def __init__(
        self,
        time_bins: Dict[int, List[int]],
        batch_size_fn: Callable[[int], int],
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        epoch: int = 1,
        force_bin: Optional[int] = None,
        force_batch_size: Optional[int] = None,
    ):
        self.time_bins = time_bins
        self.batch_size_fn = batch_size_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = epoch
        self.force_bin = force_bin
        self.force_batch_size = force_batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def get_batch_size(self, key: int) -> int:
        if self.force_batch_size is not None:
            return self.force_batch_size
        return self.batch_size_fn(key)

    def __iter__(self) -> Iterator[tuple]:
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.force_bin is not None:
            samples = {self.force_bin: list(self.time_bins[self.force_bin])}
        else:
            samples = {}
            for key, idxs in self.time_bins.items():
                if self.get_batch_size(key) <= 0:
                    continue
                idxs = list(idxs)
                if self.shuffle:
                    rng.shuffle(idxs)
                samples[key] = idxs

        while samples:
            keys = list(samples.keys())
            if self.shuffle and len(keys) > 1:
                weights = np.array(
                    [
                        len(samples[k]) // self.get_batch_size(k) + 1
                        for k in keys
                    ],
                    dtype=np.float64,
                )
                key = keys[rng.choice(len(keys), p=weights / weights.sum())]
            else:
                key = keys[0]
            current = samples[key]
            batch_size = min(len(current), self.get_batch_size(key))
            batch, remaining = current[:batch_size], current[batch_size:]
            if not remaining or (self.drop_last and len(remaining) < batch_size):
                del samples[key]
            else:
                samples[key] = remaining
            yield key, batch

    def __len__(self) -> int:
        total = 0
        for key, idxs in self.time_bins.items():
            bs = self.get_batch_size(key)
            if bs > 0:
                total += -(-len(idxs) // bs)  # ceil
        return total

"""Batch assembly with stochastic duration jitter — host-side numpy.

Parity with the reference Collater (train/dataloader.py:185-259): texts are
padded to a bucket length (a multiple of 64), not to the batch max, so a
run meets few batch shapes; all waves in a batch share the bin's frame
count, and per-sample durations get the ±1-frame jitter driven by the
cached left/right boundary-shift probabilities before the alignment matrix
is built.  The draws equal the JAX package's, so a batch is bit-identical.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..duration import duration_to_alignment_np
from .dataset import text_bucket_length


def jitter_durations(
    duration: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """duration cache row stack [3, T]: (dur, p_left, p_right) ->
    jittered integer durations (dataloader.py:236-244)."""
    dur = duration[0].astype(np.int64).copy()
    p_left = duration[1]
    p_right = duration[2]
    picks = rng.random(max(dur.shape[0] - 1, 0))
    for i in range(dur.shape[0] - 1):
        if dur[i] > 1 and dur[i + 1] > 1:
            if picks[i] < p_left[i]:
                dur[i] += 1
                dur[i + 1] -= 1
            elif picks[i] < p_left[i] + p_right[i]:
                dur[i] -= 1
                dur[i + 1] += 1
    return dur


def collate(
    items: List[dict],
    *,
    stage: str,
    rng: np.random.Generator,
    jitter: bool = True,
) -> Dict[str, np.ndarray]:
    batch_size = len(items)
    frame_count = items[0]["frame_count"]
    max_text = text_bucket_length(max(it["text"].shape[0] for it in items))

    texts = np.zeros((batch_size, max_text), np.int32)
    text_lengths = np.zeros(batch_size, np.int32)
    waves = np.zeros((batch_size, items[0]["wave"].shape[0]), np.float32)
    pitches = np.zeros((batch_size, frame_count), np.float32)
    alignments = np.zeros((batch_size, max_text, frame_count), np.float32)
    paths = []

    for i, item in enumerate(items):
        assert item["frame_count"] == frame_count, "mixed bins in batch"
        t = item["text"].shape[0]
        texts[i, :t] = item["text"]
        text_lengths[i] = t
        waves[i] = item["wave"]
        paths.append(item["path"])
        if stage != "alignment":
            if item["pitch"] is None:
                raise ValueError(f"Pitch not found for segment {item['path']}")
            p = item["pitch"].reshape(-1)[:frame_count]
            pitches[i, : p.shape[0]] = p
            dur = (
                jitter_durations(item["alignment"], rng)
                if jitter
                else item["alignment"][0].astype(np.int64)
            )
            align = duration_to_alignment_np(dur, frame_count)
            if "hubert" not in stage and dur.sum() > frame_count:
                raise ValueError(
                    f"Alignment longer than audio for {item['path']}"
                )
            alignments[i, :t, :] = align[:t]

    return dict(
        audio_gt=waves,
        text=texts,
        text_length=text_lengths,
        pitch=pitches,
        alignment=alignments,
        paths=paths,
    )

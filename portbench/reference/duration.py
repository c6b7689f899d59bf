"""Duration class tables and alignment construction.

16 nonuniform duration classes covering 1..46 frames (reference
train/utils.py:385-494), class logits -> integer durations, and durations ->
one-hot alignment by comparison against cumulative sums (no scatter).
"""

from __future__ import annotations

import numpy as np
import torch

# class id -> representative duration in frames
CLASS_TO_DUR = np.array(
    [1, 2, 3, 4, 5, 6, 7, 9, 12, 15, 18, 22, 27, 32, 38, 46], dtype=np.float32
)

# duration (0..50 frames) -> class id
DUR_TO_CLASS = np.array(
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 8, 8, 8, 9, 9, 9, 10, 10, 10, 11, 11, 11,
     11, 11, 12, 12, 12, 12, 12, 13, 13, 13, 13, 13, 14, 14, 14, 14, 14, 14, 14,
     15, 15, 15, 15, 15, 15, 15, 15, 15],
    dtype=np.int32,
)


class DurationProcessor:
    def __init__(self, class_count: int = 16, max_duration: int = 50):
        if class_count != len(CLASS_TO_DUR):
            raise ValueError(
                f"class_count {class_count} != {len(CLASS_TO_DUR)} classes"
            )
        self.class_count = class_count
        self.max_duration = max_duration

    def dur_to_class_ids(self, durs: torch.Tensor) -> torch.Tensor:
        """Durations in frames -> class ids (int64), clipped to
        [1, max_duration]."""
        durs = torch.clamp(durs, 1, self.max_duration).to(torch.int64)
        return torch.as_tensor(DUR_TO_CLASS, dtype=torch.int64,
                               device=durs.device)[durs]

    def align_to_class(self, alignment: torch.Tensor) -> torch.Tensor:
        """One-hot alignment [..., T, F] -> class ids [..., T]: the
        training target of the duration predictor."""
        return self.dur_to_class_ids(alignment.sum(dim=-1))

    def prediction_to_duration(self, pred: torch.Tensor) -> torch.Tensor:
        """Class logits [..., T, C] -> durations [..., T] (float).

        Hard argmax for short classes (<7 frames), the soft expectation
        rounded half-to-even for the wide ones."""
        class_to_dur = torch.as_tensor(CLASS_TO_DUR, device=pred.device)
        soft = (torch.softmax(pred, dim=-1) * class_to_dur).sum(dim=-1)
        soft = torch.clamp(torch.round(soft), min=1.0)
        hard = class_to_dur[torch.argmax(pred, dim=-1)]
        return torch.where(hard < 7, hard, soft)

    def batched_duration_to_alignment(
        self, duration: torch.Tensor, n_frames: int
    ) -> torch.Tensor:
        """Durations [B, T] -> one-hot alignment [B, T, n_frames] (f32).

        Token t owns frames [cumsum_excl[t], cumsum_excl[t] + dur[t]);
        frames past the total belong to no token."""
        duration = duration.to(torch.int32)
        ends = torch.cumsum(duration, dim=1)
        starts = ends - duration
        frames = torch.arange(n_frames, dtype=torch.int32,
                              device=duration.device)
        return (
            (frames >= starts[..., None]) & (frames < ends[..., None])
        ).to(torch.float32)


def duration_to_alignment_np(duration: np.ndarray, n_frames: int
                             ) -> np.ndarray:
    """Integer durations [T] -> one-hot alignment [T, n_frames] (f32) on
    the host, for the data pipeline's collate."""
    duration = duration.astype(np.int64)
    ends = np.cumsum(duration)
    starts = ends - duration
    frames = np.arange(n_frames)[None, :]
    return ((frames >= starts[:, None]) & (frames < ends[:, None])).astype(
        np.float32)

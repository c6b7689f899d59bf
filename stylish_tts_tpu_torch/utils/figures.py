"""TensorBoard validation figures: spectrogram, signed mel difference and
alignment (reference train/utils.py:151-296, train/stage.py:177-282);
matplotlib is imported only when a figure is drawn."""

from __future__ import annotations

import numpy as np


def plot_spectrogram(spec: np.ndarray, title: str = "Spectrogram"):
    """[frames, n_mels] or [n_mels, frames] -> matplotlib figure."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    if spec.ndim > 2:
        spec = spec.reshape(spec.shape[-2], spec.shape[-1])
    if spec.shape[0] > spec.shape[1]:  # orient mel bins on y
        spec = spec.T
    fig, ax = plt.subplots(figsize=(12, 5), dpi=120)
    im = ax.imshow(
        spec, aspect="auto", origin="lower", interpolation="bilinear",
        cmap="viridis",
    )
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Frames")
    ax.set_ylabel("Mel Channels")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_mel_difference(
    mel_gt: np.ndarray,
    mel_pred: np.ndarray,
    mean: float,
    std: float,
    title: str = "Signed Mel Log Diff (GT - Pred)",
    static_max_abs: float = 2.5,
):
    """Signed normalised log-mel difference heatmap
    (train/utils.py:225-296)."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    n = min(mel_gt.shape[0], mel_pred.shape[0])
    diff = mel_gt[:n] - (mel_pred[:n] - mean) / std
    fig, ax = plt.subplots(figsize=(12, 5), dpi=120)
    im = ax.imshow(
        diff.T, aspect="auto", origin="lower", interpolation="none",
        cmap="coolwarm", vmin=-static_max_abs, vmax=static_max_abs,
    )
    fig.colorbar(im, ax=ax, label="Signed Normalized Log Difference")
    ax.set_xlabel("Frames")
    ax.set_ylabel("Mel Channels")
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_attention(alignment: np.ndarray, title: str = "Alignment"):
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(dpi=120)
    im = ax.imshow(alignment, aspect="auto", origin="lower")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return fig

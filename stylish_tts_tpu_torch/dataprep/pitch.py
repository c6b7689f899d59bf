"""Ground-truth F0 precache (the JAX package's ``dataprep/pitch.py``).

A batched YIN pitch tracker in torch ops on the device — framing, FFT
autocorrelation (``torch.fft``), cumulative-mean-normalised difference,
thresholded lag pick with parabolic interpolation — and a StoneMask
refinement of each voiced frame.  YIN frames are independent of their
file, so the whole dataset flattens into one (file, frame) stream that is
processed in fixed-size chunks of [CHUNK_FRAMES, frame_len].  Output: one
[frames] float32 array per segment in ``pitch.safetensors``, 0 where
unvoiced.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

F0_FLOOR = 50.0
F0_CEIL = 600.0
YIN_WINDOW = 1024          # integration window W
YIN_THRESHOLD = 0.15
CHUNK_FRAMES = 4096        # frames a device batch


def _gather(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.gather(c, -1, t[..., None])[..., 0]


def _yin_frame_pitch(frames: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """frames [N, W + tau_max] -> f0 [N] (0 = unvoiced)."""
    tau_max = int(sample_rate / F0_FLOOR)
    tau_min = max(2, int(sample_rate / F0_CEIL))
    w = YIN_WINDOW
    x = frames.float()
    dev = x.device

    # d(tau) = e(0) + e(tau) - 2 * sum_{j<W} x_j x_{j+tau}, the
    # cross-correlation of the W-sample head with the frame by FFT
    n_fft = 1
    while n_fft < x.shape[-1] * 2:
        n_fft *= 2
    head = torch.where(torch.arange(x.shape[-1], device=dev)[None, :] < w,
                       x, 0.0)
    spec_head = torch.fft.rfft(head, n_fft)
    spec_full = torch.fft.rfft(x, n_fft)
    corr = torch.fft.irfft(torch.conj(spec_head) * spec_full, n_fft)[
        ..., : tau_max + 1]
    csum = torch.cumsum(x * x, dim=-1)
    e0 = csum[..., w - 1]
    idx = torch.arange(tau_max + 1, device=dev)
    prev = torch.where(idx > 0, csum[..., torch.clamp(idx - 1, min=0)], 0.0)
    e_tau = csum[..., idx + w - 1] - prev
    d = e0[..., None] + e_tau - 2.0 * corr

    # cumulative mean normalised difference
    cum = torch.cumsum(d[..., 1:], dim=-1)
    taus = torch.arange(1, tau_max + 1, dtype=torch.float32, device=dev)
    cmnd = d[..., 1:] * taus / torch.clamp(cum, min=1e-9)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)

    # the first tau in range under the threshold, descended to the next
    # local minimum; the global minimum in range where none crosses
    in_range = (idx >= tau_min) & (idx <= tau_max)
    below = (cmnd < YIN_THRESHOLD) & in_range
    first_below = torch.argmax(below.float(), dim=-1)
    has_below = below.any(dim=-1)
    rising = torch.cat([cmnd[..., 1:] > cmnd[..., :-1],
                        torch.ones_like(cmnd[..., :1], dtype=torch.bool)],
                       dim=-1)
    stop = rising & (idx[None, :] >= first_below[..., None])
    local_min = torch.argmax(stop.float(), dim=-1)
    masked = torch.where(in_range, cmnd, math.inf)
    tau_best = torch.where(has_below, local_min,
                           torch.argmin(masked, dim=-1))

    # parabolic interpolation around tau_best
    t0 = torch.clamp(tau_best, tau_min + 1, tau_max - 1)
    cm1 = _gather(cmnd, t0 - 1)
    c0 = _gather(cmnd, t0)
    cp1 = _gather(cmnd, t0 + 1)
    denom = cm1 + cp1 - 2.0 * c0
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (cm1 - cp1) / denom, 0.0)
    tau_ref = t0.float() + torch.clamp(delta, -1.0, 1.0)

    voiced = c0 < YIN_THRESHOLD * 2.0
    # energy gate: silence has a degenerate (all-zero) difference function
    voiced = voiced & (e0 > 1e-4)
    f0 = torch.where(voiced, sample_rate / torch.clamp(tau_ref, min=1.0),
                     0.0)
    return torch.where((f0 >= F0_FLOOR) & (f0 <= F0_CEIL), f0, 0.0)


def _stonemask_refine(
    frames: torch.Tensor, f0: torch.Tensor, sample_rate: int,
    harmonics: int = 3, delta: int = 64, iters: int = 2,
) -> torch.Tensor:
    """Instantaneous-frequency refinement of YIN candidates (the role of
    WORLD's StoneMask).  For each voiced frame and harmonic k, the phase
    advance between two Hann-windowed windows Δ samples apart, unwrapped
    around k·f0, gives the harmonic's instantaneous frequency; the refined
    f0 is the amplitude-weighted mean of IF_k / k, clipped to ±100 cents
    of the candidate.  Two iterations."""
    L = 512
    # the two windows sit around the frame's hop point (mid-frame)
    start = (frames.shape[1] - L - delta) // 2
    x1 = frames[:, start:start + L].float()
    x2 = frames[:, start + delta:start + delta + L].float()
    n = torch.arange(L, dtype=torch.float32, device=frames.device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (L - 1))
    voiced = f0 > 0
    fc = torch.where(voiced, f0, 100.0)  # a dummy frequency where unvoiced

    def one_iter(fc):
        num = torch.zeros_like(fc)
        den = torch.zeros_like(fc)
        for k in range(1, harmonics + 1):
            phase = (2.0 * math.pi * k / sample_rate) * fc[:, None] * n[None]
            c = torch.cos(phase) * hann
            s = torch.sin(phase) * hann
            re1 = (x1 * c).sum(dim=-1)
            im1 = -(x1 * s).sum(dim=-1)
            re2 = (x2 * c).sum(dim=-1)
            im2 = -(x2 * s).sum(dim=-1)
            # angle(c2 * conj(c1)) = phase advance over Δ samples
            cross_re = re2 * re1 + im2 * im1
            cross_im = im2 * re1 - re2 * im1
            dphi = torch.atan2(cross_im, cross_re)
            expected = 2.0 * math.pi * k * fc * delta / sample_rate
            wrapped = torch.remainder(dphi - expected + math.pi,
                                      2 * math.pi) - math.pi
            if_k = k * fc + wrapped * sample_rate / (2.0 * math.pi * delta)
            amp = torch.sqrt(re1 * re1 + im1 * im1) + 1e-12
            num = num + amp * (if_k / k)
            den = den + amp
        ref = num / den
        lo, hi = fc * (2.0 ** (-100 / 1200)), fc * (2.0 ** (100 / 1200))
        return torch.minimum(torch.maximum(ref, lo), hi)

    for _ in range(iters):
        fc = one_iter(fc)
    out = torch.where(voiced, fc, 0.0)
    return torch.where((out >= F0_FLOOR) & (out <= F0_CEIL), out, 0.0)


def _yin(frames: torch.Tensor, sample_rate: int) -> torch.Tensor:
    with torch.no_grad():
        return _stonemask_refine(
            frames, _yin_frame_pitch(frames, sample_rate), sample_rate)


def _file_frames(wave: np.ndarray, sample_rate: int, hop_length: int):
    """[T] audio -> [n_frames, frame_len] analysis windows on the hop grid
    (zero-copy strided view)."""
    tau_max = int(sample_rate / F0_FLOOR)
    frame_len = YIN_WINDOW + tau_max
    n_frames = wave.shape[0] // hop_length + 1
    pad = frame_len // 2
    padded = np.pad(wave, (pad, pad + frame_len))
    windows = np.lib.stride_tricks.sliding_window_view(padded, frame_len)
    return windows[: n_frames * hop_length : hop_length], n_frames


def _median3(f0: np.ndarray) -> np.ndarray:
    if f0.shape[0] >= 3:
        stacked = np.stack([f0[:-2], f0[1:-1], f0[2:]])
        f0 = f0.copy()
        f0[1:-1] = np.median(stacked, axis=0)
    return f0.astype(np.float32)


def extract_pitch_batch(waves, sample_rate: int, hop_length: int,
                        device=None) -> list:
    """List of [T] audio -> list of [T//hop + 1] f0 tracks, on ``device``
    (the card unless named).

    Every file's frames go into one stream, run in CHUNK_FRAMES-size
    batches (the last one zero-padded), so the device batches stay full
    whatever the corpus's lengths."""
    from ..device import resolve_device

    device = resolve_device(device)
    per_file = [
        _file_frames(np.asarray(w, np.float32), sample_rate, hop_length)
        for w in waves
    ]
    counts = [n for _, n in per_file]
    total = sum(counts)
    if total == 0:
        return [np.zeros(0, np.float32) for _ in waves]
    frame_len = per_file[0][0].shape[1]
    out = np.empty(total, np.float32)
    stream_pos = 0
    buf = np.zeros((CHUNK_FRAMES, frame_len), np.float32)
    fill = 0

    def run(rows: int) -> None:
        nonlocal stream_pos
        f0 = _yin(torch.from_numpy(buf).to(device), sample_rate)
        out[stream_pos : stream_pos + rows] = f0[:rows].cpu().numpy()
        stream_pos += rows

    for frames, n in per_file:
        taken = 0
        while taken < n:
            step = min(CHUNK_FRAMES - fill, n - taken)
            buf[fill : fill + step] = frames[taken : taken + step]
            fill += step
            taken += step
            if fill == CHUNK_FRAMES:
                run(fill)
                fill = 0
    if fill:
        buf[fill:] = 0.0
        run(fill)
    results = []
    pos = 0
    for n in counts:
        results.append(_median3(out[pos : pos + n]))
        pos += n
    return results


def calculate_pitch(config, model_config, method: str = "yin",
                    device=None) -> Dict[str, np.ndarray]:
    """Precache F0 for the val and train splits into ``pitch.safetensors``
    (written by ``utils/tensorfile.py``); returns what it wrote.  YIN runs
    on ``device`` (the card unless named).  ``rmvpe`` is not ported."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data.audio import read_wav
    from ..data.dataset import get_data_path_list
    from ..device import resolve_device
    from ..utils.tensorfile import write_safetensors

    if method == "rmvpe":
        raise NotImplementedError(
            "pitch --method rmvpe is not ported yet: Queue 1 item 6 (the "
            "frozen RMVPE net); use --method yin")
    if method != "yin":
        raise ValueError(f"unknown pitch method {method!r}")
    device = resolve_device(device)
    root = Path(config.dataset.path)
    wavdir = root / config.dataset.wav_path
    out: Dict[str, np.ndarray] = {}
    sr, hop = model_config.sample_rate, model_config.hop_length
    GROUP = 64  # files per device megabatch (bounds host RAM)
    with ThreadPoolExecutor(8) as pool:
        for split in (config.dataset.val_data, config.dataset.train_data):
            lines = get_data_path_list(root / split)
            names = [
                f[0]
                for f in (line.strip().split("|") for line in lines)
                if len(f) == 4
            ]
            done = 0
            for g in range(0, len(names), GROUP):
                group = names[g : g + GROUP]
                waves = list(
                    pool.map(lambda n: read_wav(wavdir / n, sr), group))
                for name, f0 in zip(
                    group, extract_pitch_batch(waves, sr, hop, device=device)
                ):
                    out[name] = f0
                done += len(group)
                if done % 512 < GROUP:
                    logger.info("%s: %d/%d", split, done, len(names))
    write_safetensors(root / config.dataset.pitch_path, out)
    logger.info("wrote %s (%d segments)", config.dataset.pitch_path, len(out))
    return out

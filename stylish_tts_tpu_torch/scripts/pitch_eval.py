"""Cents error of YIN, raw and refined, against the known F0 of
speech-like utterances.

    python -m stylish_tts_tpu_torch.scripts.pitch_eval [--out f.json] [--cpu] [--utts 16]

The utterances come from ``utils/synthetic.py:make_speechlike`` (harmonic
stacks under formants on a contour of vibrato, jitter and declination,
with fricative and silent stretches), so the error is measured against
the truth that made the signal, not against another estimator.
``yin_raw`` is YIN's track (``extract_pitch_batch(refine=False)``),
``yin_stonemask_refined`` the track after the instantaneous-frequency
refinement that the ``pitch`` command caches.  Each reports the mean and
95th percentile of the cents error on frames both call voiced, the share
of them off by more than 100 cents, and the voicing F1.  The YIN runs on
the card unless ``--cpu`` is given; the report is one JSON line, and
``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SAMPLE_RATE, HOP = 24000, 300
SEED = 42


def score(est_list, gt_list) -> dict:
    """Cents error on the frames both tracks call voiced (mean, 95th
    percentile, share over 100 cents) and the voicing F1, over tracks
    cut to their common length."""
    cents_errs = []
    tp = fp = fn = 0
    for e, gt in zip(est_list, gt_list):
        m = min(len(e), len(gt))
        e, gt = e[:m], gt[:m]
        tp += int(((e > 0) & (gt > 0)).sum())
        fp += int(((e > 0) & (gt == 0)).sum())
        fn += int(((e == 0) & (gt > 0)).sum())
        both = (e > 0) & (gt > 0)
        if both.any():
            cents_errs.append(np.abs(1200 * np.log2(e[both] / gt[both])))
    cents = np.concatenate(cents_errs)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return {
        "cents_mae": round(float(cents.mean()), 2),
        "cents_p95": round(float(np.percentile(cents, 95)), 2),
        "gross_error_rate": round(float((cents > 100).mean()), 5),
        "vuv_f1": round(
            2 * precision * recall / max(precision + recall, 1e-9), 4
        ),
    }


def speechlike_suite(utts: int, seed: int = SEED):
    """(waves, true F0 tracks) of ``utts`` utterances at F0 bases drawn
    from 90-260 Hz."""
    from ..utils.synthetic import make_speechlike

    rng = np.random.default_rng(seed)
    waves, gts = [], []
    for _ in range(utts):
        w, f0, _ = make_speechlike(rng, f0_base=float(rng.uniform(90, 260)))
        waves.append(w)
        gts.append(f0)
    return waves, gts


def evaluate(utts: int = 16, device=None):
    """(the report, the tracks) over ``utts`` utterances, the YIN on
    ``device`` (the card unless named); the tracks are the per-utterance
    F0 tracks under the report's names."""
    from ..dataprep.pitch import extract_pitch_batch

    waves, gts = speechlike_suite(utts)
    tracks = {name: extract_pitch_batch(waves, SAMPLE_RATE, HOP,
                                        refine=refine, device=device)
              for name, refine in (("yin_raw", False),
                                   ("yin_stonemask_refined", True))}
    report = {
        "suite": f"{utts} speech-like utterances (vibrato, jitter, "
                 "declination, formants, fricatives; known-truth F0)",
        **{name: score(track, gts) for name, track in tracks.items()},
    }
    return report, tracks


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--utts", type=int, default=16)
    args = ap.parse_args(argv)
    report, _ = evaluate(args.utts, device="cpu" if args.cpu else None)
    print(json.dumps(report))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

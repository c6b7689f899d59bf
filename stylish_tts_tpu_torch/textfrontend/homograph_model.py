"""Learned homograph disambiguator (VERDICT r3 #5).

The reference disambiguates with per-word sklearn classifiers over
ModernBERT embeddings + spacy POS tags (reference
lib/ttab/homographs.py:17-40) — all requiring downloads.  This module is
the air-gapped learned equivalent: one shared logistic regression over
HASHED surface features of the ±3-token context window, with stem-
conjoined copies of every feature so per-word decision boundaries emerge
from shared weights (a factored form of the reference's per-word models).

Features are raw surface forms only (token identity / suffix at each
offset, and their stem conjunctions) — the model learns its own cue
classes from the training sentences instead of importing the rule lists
in homographs.py, so the A/B against the rule scorer is a genuine
comparison of two mechanisms.

Training data is generated by scripts/train_homographs.py from grammar
templates (determiner/modal/pronoun frames filled with vocabulary), never
from the evaluation sentence files.  Weights ship as a committed .npz.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import List, Optional

import numpy as np

DIM = 1 << 15  # hashed feature space
_WEIGHTS_PATH = Path(__file__).parent / "data" / "homograph_lr.npz"


def _hash(feature: str) -> int:
    # stable across processes (unlike hash()) and runs
    return int.from_bytes(
        hashlib.blake2s(feature.encode(), digest_size=4).digest(), "little"
    ) % DIM


def feature_indices(stem: str, left: List[str], right: List[str]) -> np.ndarray:
    """Hashed feature indices (sparse row) for one decision context."""
    toks_l = [w.lower() for w in left if w][-3:]
    toks_r = [w.lower() for w in right if w][:2]
    feats = [f"stem={stem}"]
    for i, tok in enumerate(reversed(toks_l)):  # L1 = adjacent-left
        feats.append(f"L{i + 1}={tok}")
        feats.append(f"L{i + 1}suf={tok[-2:]}")
    for i, tok in enumerate(toks_r):
        feats.append(f"R{i + 1}={tok}")
        feats.append(f"R{i + 1}suf={tok[-2:]}")
    if not toks_l:
        feats.append("L_none")
    if not toks_r:
        feats.append("R_none")
    if toks_l and toks_r:
        feats.append(f"LR={toks_l[-1]}|{toks_r[0]}")
    # stem-conjoined copies: per-word boundaries from shared weights
    feats.extend([f"{stem}#{f}" for f in list(feats)])
    return np.array([_hash(f) for f in feats], np.int64)


def pack_indices(rows: List[np.ndarray]) -> np.ndarray:
    """Pad per-row index lists to a rectangle; slot DIM-1 is reserved as
    the padding bucket (its weight is pinned to zero during training)."""
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), DIM - 1, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def rule_score(stem: str, left: List[str], right: List[str]) -> float:
    """The hand-written cue scorer, exposed as ONE stacked feature — the
    model learns how much to trust it (standard model stacking)."""
    from .homographs import _verb_score

    return float(_verb_score(stem, left, right))


class LearnedHomographClassifier:
    """callable(stem, left, right) -> 0 (noun/adj) | 1 (verb), the
    ``Homographs(classifier=...)`` hook.  Stacked form: hashed-feature
    weights + a learned coefficient on the rule scorer's output."""

    def __init__(self, w: np.ndarray, b: float, alpha: float = 0.0):
        self.w = w.astype(np.float32)
        self.b = float(b)
        self.alpha = float(alpha)

    def __call__(self, stem: str, left: List[str], right: List[str]) -> int:
        return int(self.score(stem, left, right) > 0.0)

    def score(self, stem: str, left: List[str], right: List[str]) -> float:
        idx = feature_indices(stem, left, right)
        return float(
            self.w[idx].sum()
            + self.alpha * rule_score(stem, left, right)
            + self.b
        )

    @classmethod
    def load(cls, path: Optional[Path] = None) -> "LearnedHomographClassifier":
        data = np.load(path or _WEIGHTS_PATH)
        return cls(data["w"], data["b"], data.get("alpha", 0.0))

    def save(self, path: Optional[Path] = None) -> None:
        p = path or _WEIGHTS_PATH
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            p, w=self.w, b=np.float32(self.b), alpha=np.float32(self.alpha)
        )


def train_logreg(
    I: np.ndarray, y: np.ndarray, rs: Optional[np.ndarray] = None, *,
    epochs: int = 200, lr: float = 0.5, l2: float = 1e-4, seed: int = 0,
) -> LearnedHomographClassifier:
    """Minibatch logistic regression over hashed SPARSE rows (numpy; no
    sklearn in the image).  ``I`` is the padded index matrix from
    ``pack_indices`` (padding bucket DIM-1 stays pinned at zero); ``rs``
    is the optional stacked rule-score column."""
    rng = np.random.default_rng(seed)
    n = len(I)
    w = np.zeros(DIM, np.float32)
    b = 0.0
    alpha = 0.0
    if rs is None:
        rs = np.zeros(n, np.float32)
    order = np.arange(n)
    for _ in range(epochs):
        rng.shuffle(order)
        for chunk in np.array_split(order, max(n // 512, 1)):
            Ic = I[chunk]
            z = w[Ic].sum(axis=1) + alpha * rs[chunk] + b
            p = 1.0 / (1.0 + np.exp(-z))
            gm = p - y[chunk]
            g = gm * (lr / len(chunk))
            w *= 1.0 - lr * l2
            np.subtract.at(w, Ic.ravel(), np.repeat(g, Ic.shape[1]))
            alpha -= lr * float((gm * rs[chunk]).mean())
            b -= lr * float(gm.mean())
            w[DIM - 1] = 0.0
    return LearnedHomographClassifier(w, b, alpha)


def predict(
    clf: LearnedHomographClassifier, I: np.ndarray,
    rs: Optional[np.ndarray] = None,
) -> np.ndarray:
    z = clf.w[I].sum(axis=1) + clf.b
    if rs is not None:
        z = z + clf.alpha * rs
    return (z > 0).astype(np.float32)

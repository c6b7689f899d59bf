"""Train the learned homograph classifier on sentences generated from
grammar templates, and write its weights.

    python -m stylish_tts_tpu_torch.scripts.train_homographs [--epochs 200] [--out f.npz]

Each heteronym stem fills noun frames (label 0) and verb frames (label
1), each frame also with two of its other words swapped for fillers; the
sentences are disjoint from the evaluation sentences of
``tests/data/heteronym_sentences_external.tsv``, which are never read
here.  90% of them (a fixed permutation) train a logistic regression over
hashed context features stacked on the rule scorer
(``textfrontend/homograph_model.py:train_logreg``); the rest are held
out.  Writes ``textfrontend/data/homograph_lr.npz`` unless ``--out`` names
another file, and prints the accuracies as one JSON line.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..textfrontend.homograph_model import (_WEIGHTS_PATH, feature_indices,
                                            pack_indices, predict,
                                            rule_score, train_logreg)
from ..textfrontend.homographs import HOMOGRAPHS

# noun/adjective-slot frames: {w} marks the heteronym position
NOUN_FRAMES = [
    "the {w} was old",
    "a {w} is here",
    "this {w} looks fine",
    "his {w} broke yesterday",
    "her {w} seems small",
    "that {w} on the shelf",
    "an unusual {w} appeared",
    "my {w} works well",
    "their {w} was lost",
    "every {w} matters",
    "some {w} arrived today",
    "no {w} was found",
    "the {w} of the house",
    "a {w} for the children",
    "the {w} in the garden",
    "one {w} per family",
    "the old {w} fell apart",
    "a small {w} stood there",
    "the first {w} of the year",
    "each {w} costs money",
    "whose {w} is this",
    "another {w} arrived",
    "they saw the {w}",
    "we bought a {w}",
    "he dropped the {w} again",
    "it was a very {w} matter",
    "a rather {w} answer",
    "the most {w} room",
    "such a {w} plan",
    "how {w} the weather is",
    "fresh {w} is sold here",
    "more {w} was needed",
    "a gust of {w} came through",
    "a piece of {w} lay there",
    "full of {w} and dust",
    "the {w} broadcast begins soon",
    "the {w} was so strong",
    "too {w} to the fire",
    "he lives {w} to the station",
    "the {w} stretches for miles",
    "it had to hold more {w}",
    "she suffered a deep {w}",
    "get the {w} out",
    "upon seeing the {w} there",
    "shed a single {w}",
]
VERB_FRAMES = [
    "they {w} the boxes",
    "we {w} it daily",
    "i {w} them often",
    "you {w} the papers",
    "she will {w} the door",
    "he would {w} the offer",
    "we can {w} the goods",
    "they could {w} more food",
    "you may {w} the letter",
    "it might {w} the price",
    "we shall {w} the plan",
    "you should {w} the rope",
    "they must {w} the cargo",
    "please {w} the form",
    "do not {w} the page",
    "did you {w} the gift",
    "we do {w} the laundry",
    "to {w} the wheat takes time",
    "she wants to {w} it",
    "let us {w} the tickets",
    "help me {w} the sail",
    "who will {w} the award",
    "farmers {w} the fields",
    "workers {w} the steel",
    "students {w} their essays",
    "i never {w} my friends",
    "they always {w} the rules",
    "we often {w} the data",
    "children {w} it quickly",
    "he did not {w} the claim",
    "it was {w} around the pole",
    "the rope was {w} tightly",
    "the cloth is {w} by hand",
    "it had to {w} more cargo",
    "decided to {w} the post",
    "taught him to {w} seeds",
    "it was time to {w} the gifts",
    "too strong to {w} the sail",
    "trying to {w} the gap",
    "he had to {w} the subject",
    "how can i {w} this to her",
    "refused to {w} the terms",
    "the birds {w} into the bushes",
    "metals {w} when they cool",
    "the two sides {w} sharply",
    "day and night {w} endlessly",
    "prices {w} every year",
    "we {w} against the plan",
]
# filler nouns to diversify the non-target slots
FILLERS = [
    "box", "letter", "field", "door", "paper", "plan", "rope", "gift",
    "road", "song", "tool", "meal", "coat", "lamp", "book", "card",
]


def build_dataset(seed: int = 0):
    """(stem, left tokens, right tokens, label) of every templated
    sentence; ``seed`` draws the filler swaps."""
    rng = np.random.default_rng(seed)
    rows = []  # (stem, left, right, label)
    for stem in HOMOGRAPHS:
        for frames, label in ((NOUN_FRAMES, 0), (VERB_FRAMES, 1)):
            for frame in frames:
                sent = frame.format(w=stem)
                # filler variation: swap one random non-target token
                toks = sent.split()
                j = toks.index(stem)
                variants = [toks]
                for _ in range(2):
                    t2 = list(toks)
                    slots = [
                        k for k, t in enumerate(t2)
                        if k != j and t.isalpha() and len(t) > 3
                    ]
                    if slots:
                        k = int(rng.integers(len(slots)))
                        t2[slots[k]] = FILLERS[int(rng.integers(len(FILLERS)))]
                    variants.append(t2)
                for t in variants:
                    rows.append((stem, t[:j], t[j + 1:], label))
    return rows


def train(epochs: int = 200, out: Optional[Path] = None) -> dict:
    """Train on the templates' 90% split, write the weights to ``out``
    (the package's ``homograph_lr.npz`` unless given) and return the
    report: split sizes, train and held-out accuracy, the rule feature's
    weight and the file written."""
    rows = build_dataset()
    rng = np.random.default_rng(1)
    order = rng.permutation(len(rows))
    split = int(0.9 * len(rows))
    tr, te = order[:split], order[split:]

    I = pack_indices([feature_indices(s, l, r) for s, l, r, _ in rows])
    y = np.array([lab for *_, lab in rows], np.float32)
    rs = np.array([rule_score(s, l, r) for s, l, r, _ in rows], np.float32)

    clf = train_logreg(I[tr], y[tr], rs[tr], epochs=epochs)
    acc_tr = float((predict(clf, I[tr], rs[tr]) == y[tr]).mean())
    acc_te = float((predict(clf, I[te], rs[te]) == y[te]).mean())
    out = Path(out) if out is not None else _WEIGHTS_PATH
    clf.save(out)
    return {
        "train_sentences": len(tr),
        "heldout_sentences": len(te),
        "train_acc": round(acc_tr, 4),
        "heldout_template_acc": round(acc_te, 4),
        "rule_feature_alpha": round(clf.alpha, 4),
        "weights": str(out),
    }


def compare_weights(got: Path, want: Path = _WEIGHTS_PATH) -> dict:
    """Whether two weight files hold the same ``w``, ``b`` and ``alpha``
    bit for bit, and the largest absolute difference of each."""
    a, b = np.load(got), np.load(want)
    diff = {k: float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64))))
            for k in ("w", "b", "alpha")}
    return {"equal": all(np.array_equal(a[k], b[k])
                         for k in ("w", "b", "alpha")),
            "max_abs_diff": diff}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="weights file (default: the package's "
                         "textfrontend/data/homograph_lr.npz)")
    args = ap.parse_args(argv)
    print(json.dumps(train(args.epochs, args.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

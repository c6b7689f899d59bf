"""The one generator of every traffic mix: ``traffic/<name>.json`` holds a
mix's parameters, and this module turns them and ``--seed`` into inputs.

Two kinds of mix (the ``kind`` names the module that drives it,
``portbench/<kind>_cell.py``):

- ``"train"``: a pool of ``pool`` host batches of ``batch`` rows and
  ``frames`` mel frames (the rule of ``chip_smoke.py:synthetic_batch``:
  token strings drawn from the inventory, durations summing to the frames
  with a one-hot alignment, F0 of 80-300 Hz with unvoiced stretches, and
  audio that is a harmonic signal on that F0 plus noise).  Every row of
  the pool differs.  The text is padded to ``frames // 6`` tokens, the most
  a row draws, so every seed gives the same shapes;
- ``"synth"``: a cycle of ``cycle`` batches of ``batch`` phoneme strings
  whose lengths are the ``cycle * batch`` evenly spaced values of
  ``phonemes`` [lo, hi], in an order drawn from the seed: every seed sends
  the same set of sizes.  With ``"order": "by_length"`` the lengths are
  sorted before they are cut into batches (requests grouped by length),
  and the batches' order is drawn from the seed; the default,
  ``"drawn"``, draws the order of the lengths themselves.

Seeds may be any non-negative whole number; each draw takes its own
stream of ``numpy.random.SeedSequence([seed, stream])``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from .reference.text import TextCleaner

# the streams of one seed
TRAIN_POOL, SYNTH_ORDER, SYNTH_TEXT = 1, 2, 3


def load(root: Path, name: str) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream,
                                                         index]))


def phoneme_strings(symbols, counts, gen: np.random.Generator) -> List[str]:
    """One string of symbols drawn from the inventory per count."""
    inventory = list(symbols.letters_ipa + symbols.letters)
    texts = ["".join(gen.choice(inventory, n)) for n in counts]
    cleaner = TextCleaner(symbols)
    for text, n in zip(texts, counts):
        if len(cleaner(text)) != n:
            raise AssertionError("a drawn symbol is not in the inventory")
    return texts


def train_batch(mc, batch: int, frames: int, gen: np.random.Generator
                ) -> Dict[str, np.ndarray]:
    """One acoustic batch as numpy arrays (see the module's docstring)."""
    width = frames // 6
    counts = [int(n) for n in gen.integers(frames // 12, width, batch)]
    cleaner = TextCleaner(mc.symbol)
    texts = phoneme_strings(mc.symbol, counts, gen)
    tokens = np.zeros((batch, width), np.int64)
    alignment = np.zeros((batch, width, frames), np.float32)
    for i, (text, n) in enumerate(zip(texts, counts)):
        tokens[i, :n] = cleaner(text)
        cuts = np.sort(gen.choice(np.arange(1, frames), n - 1,
                                  replace=False))
        for t, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, frames])):
            alignment[i, t, lo:hi] = 1.0
    pitch = np.zeros((batch, frames), np.float32)
    for i in range(batch):
        t, voiced = 0, bool(gen.integers(2))
        while t < frames:
            run = int(gen.integers(10, 60))
            if voiced:
                pitch[i, t:t + run] = np.linspace(
                    *gen.uniform(80.0, 300.0, 2), len(pitch[i, t:t + run]))
            t, voiced = t + run, not voiced
    hop = mc.hop_length
    f0 = np.repeat(pitch, hop, axis=1)
    phase = 2 * np.pi * np.cumsum(f0 / mc.sample_rate, axis=1)
    audio = sum(0.3 / k * np.sin(k * phase) for k in range(1, 9)) * (f0 > 0)
    audio = audio + 0.01 * gen.standard_normal(audio.shape)
    return dict(text=tokens, text_length=np.array(counts, np.int64),
                alignment=alignment, pitch=pitch,
                audio_gt=audio.astype(np.float32))


def train_pool(mc, mix: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    return [train_batch(mc, mix["batch"], mix["frames"],
                        rng(seed, TRAIN_POOL, i)) for i in range(mix["pool"])]


def synth_cycle(mc, mix: dict, seed: int) -> List[List[str]]:
    """``cycle`` batches of phoneme strings (see the module's docstring)."""
    lo, hi = mix["phonemes"]
    b, n = mix["batch"], mix["cycle"] * mix["batch"]
    counts = np.rint(np.linspace(lo, hi, n)).astype(int)
    order = mix.get("order", "drawn")
    if order == "drawn":
        counts = rng(seed, SYNTH_ORDER).permutation(counts)
    elif order == "by_length":
        batches = rng(seed, SYNTH_ORDER).permutation(mix["cycle"])
        counts = np.concatenate([counts[i * b:(i + 1) * b] for i in batches])
    else:
        raise ValueError(f"no order {order!r}: 'drawn' or 'by_length'")
    texts = phoneme_strings(mc.symbol, [int(c) for c in counts],
                            rng(seed, SYNTH_TEXT))
    return [texts[i:i + b] for i in range(0, n, b)]


def longest_batch(mc, mix: dict, seed: int) -> List[str]:
    """A batch of the longest strings the mix sends: its largest text and
    frame bucket, for the warm-up."""
    return phoneme_strings(mc.symbol, [mix["phonemes"][1]] * mix["batch"],
                           rng(seed, SYNTH_TEXT, 1))

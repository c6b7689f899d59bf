"""The port's text front end against the JAX package's: ``G2P`` without
espeak on every entry of the three G2P corpora in ``tests/data/``,
``normalize_text``, ``split_sentences`` and ``number_to_words``, and the
homograph classifier's weights.  Host code on both sides (no JAX trace):
the strings must be identical."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from stylish_tts_tpu import textfrontend as jtf
from stylish_tts_tpu.textfrontend import homograph_model as jhm
from stylish_tts_tpu_torch import textfrontend as ptf
from stylish_tts_tpu_torch.config import SymbolConfig
from stylish_tts_tpu_torch.text import TextCleaner
from stylish_tts_tpu_torch.textfrontend import homograph_model as phm

DATA = Path(__file__).parent / "data"
CORPORA = ("g2p_golden.tsv", "cmudict_arpabet_1k.tsv",
           "heteronym_sentences_external.tsv")


@pytest.fixture(scope="module")
def g2ps():
    return jtf.G2P(use_espeak=False), ptf.G2P(use_espeak=False)


def corpus(name: str):
    """The first field of each entry (a word or a sentence)."""
    lines = (DATA / name).read_text(encoding="utf-8").splitlines()
    return [line.split("\t")[0] for line in lines
            if line.strip() and not line.startswith("#")]


@pytest.mark.parametrize("name", CORPORA)
def test_g2p_identical_on_corpus(g2ps, name):
    jax_g2p, port_g2p = g2ps
    entries = corpus(name)
    assert len(entries) > 100
    diff = [(e, jax_g2p(e), port_g2p(e)) for e in entries
            if jax_g2p(e) != port_g2p(e)]
    assert not diff, diff[:5]
    words = {w for e in entries for w in e.split() if w.isalpha()}
    diff = [w for w in sorted(words) if jax_g2p.word(w) != port_g2p.word(w)]
    assert not diff, diff[:5]


BOOK = ("Chapter 1. Dr. Smith read 3 books in 1999; he paid $25.50 for the "
        "lead record, 100% of it! Mr. Jones lives at 221B Baker St. and "
        "was 2nd in the race... Was he? Yes: the 21st time, at 5 p.m., "
        "“quoted” and (bracketed) text — all of it.")
TEXTS = [
    "I paid $25 for 3 books in 1999, 100% true...",
    "the 3rd of May, the 21st time",
    "Dr. Smith arrived at 5 p.m. yesterday. He was tired! Was he? Yes.",
    BOOK,
    "  Multiple   spaces\nand\tnewlines. Numbers like -5, 3.14 and 1,234.",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_normalize_and_split_identical(i, g2ps):
    text = TEXTS[i]
    norm = jtf.normalize_text(text)
    assert ptf.normalize_text(text) == norm
    assert ptf.split_sentences(norm) == jtf.split_sentences(norm)
    jax_g2p, port_g2p = g2ps
    assert [port_g2p(s) for s in ptf.split_sentences(norm)] == \
        [jax_g2p(s) for s in jtf.split_sentences(norm)]


def test_number_to_words_identical():
    cases = [0, 7, 21, 115, 1000, 1234567, -5, "3.14", 1999, 2024, 10 ** 9]
    cases += list(np.random.default_rng(0).integers(0, 10 ** 7, 200))
    for n in cases:
        n = n if isinstance(n, str) else int(n)
        assert ptf.number_to_words(n) == jtf.number_to_words(n), n


def test_homograph_weights_are_the_same_file():
    jax_file = Path(jhm.__file__).parent / "data" / "homograph_lr.npz"
    port_file = Path(phm.__file__).parent / "data" / "homograph_lr.npz"
    assert port_file.read_bytes() == jax_file.read_bytes()
    assert phm.LearnedHomographClassifier.load() is not None


def test_g2p_output_in_the_symbol_set(g2ps):
    _, port_g2p = g2ps
    cleaner = TextCleaner(SymbolConfig())
    text = ptf.normalize_text(BOOK)
    phonemes = port_g2p(text)
    assert len(cleaner(phonemes)) == len(phonemes)

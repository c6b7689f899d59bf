"""Text normalisation + sentence splitting for the audiobook/long-form
pipeline.

Capability parity with the reference ttab tokens module
(lib/ttab/tokens.py): regex cleanup, number/currency/percent expansion and
sentence tokenization.  Self-contained — the reference depends on inflect +
nltk Punkt, neither guaranteed in an air-gapped pod, so number spelling and
the sentence splitter are implemented here directly."""

from __future__ import annotations

import re
from typing import List

ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
          (10**2, "hundred")]


def _below_thousand(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(ONES[n // 100] + " hundred")
        n %= 100
        if n:
            parts.append("and")
    if n >= 20:
        if n % 10:
            parts.append(TENS[n // 10] + "-" + ONES[n % 10])
        else:
            parts.append(TENS[n // 10])
    elif n > 0 or not parts:
        parts.append(ONES[n])
    return " ".join(parts)


def number_to_words(number: str | int | float, zero: str = "oh") -> str:
    """Spell a number in English words (inflect-compatible enough for TTS)."""
    s = str(number).replace(",", "").strip()
    if s.startswith("-"):
        return "minus " + number_to_words(s[1:], zero=zero)
    if "." in s:
        whole, frac = s.split(".", 1)
        frac_words = " ".join(
            zero if c == "0" else ONES[int(c)] for c in frac if c.isdigit()
        )
        whole_words = number_to_words(whole or "0", zero=zero)
        return f"{whole_words} point {frac_words}"
    if not s.isdigit():
        return s
    n = int(s)
    if n == 0:
        return "zero" if zero == "zero" else zero
    parts = []
    for scale, name in ((10**12, "trillion"), (10**9, "billion"),
                        (10**6, "million"), (10**3, "thousand")):
        if n >= scale:
            parts.append(_below_thousand(n // scale) + " " + name)
            n %= scale
    if n:
        parts.append(_below_thousand(n))
    return " ".join(parts)


def _year_to_words(y: int) -> str:
    if 1100 <= y <= 1999 and y % 100 != 0:
        return _below_thousand(y // 100) + " " + (
            "oh " + ONES[y % 100] if y % 100 < 10 else _below_thousand(y % 100)
        )
    if 2000 <= y <= 2009:
        return "two thousand" + ("" if y == 2000 else " and " + ONES[y % 100])
    if 2010 <= y <= 2099:
        return "twenty " + (
            "oh " + ONES[y % 100] if y % 100 < 10 else _below_thousand(y % 100)
        )
    return number_to_words(y)


_CLEANUP = [
    (re.compile(r"\s+"), " "),
    (re.compile(r"[\[\({](?:.{0,15})[0-9](?:.{0,15})[\]\)}]"), " "),
    (re.compile(r"[\\>\[\]*_/@#]"), " "),
    (re.compile(r"[™•]"), ""),
    (re.compile(r"\.\.\."), " … "),
    (re.compile(r"%"), " percent "),
    (re.compile(r"×"), " times "),
    (re.compile(r"="), " equals "),
    (re.compile(r"\+"), " plus "),
    (re.compile(r"&"), " and "),
    (re.compile(r"°"), " degrees "),
    (re.compile(r"---*"), " — "),
    (re.compile(r"\s-\s"), " — "),
    (re.compile(r"[–]"), " — "),
]

_CURRENCY = [
    (re.compile(r"\$(\d[\d,]*)(\.\d+)?"), "dollars"),
    (re.compile(r"£(\d[\d,]*)(\.\d+)?"), "pounds"),
    (re.compile(r"€(\d[\d,]*)(\.\d+)?"), "euros"),
]

_ORDINAL = re.compile(r"\b(\d+)(st|nd|rd|th)\b")
_YEAR = re.compile(r"\b(1[1-9]\d\d|20\d\d)\b")
_NUMBER = re.compile(r"\b\d[\d,]*(\.\d+)?\b")

ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinal_words(n: int) -> str:
    words = number_to_words(n, zero="zero")
    head, _, last = words.rpartition(" ")
    if "-" in last:
        t, _, o = last.partition("-")
        last = t + "-" + ORDINAL_SPECIAL.get(o, o + "th")
    elif last in ORDINAL_SPECIAL:
        last = ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def normalize_text(text: str) -> str:
    for pattern, repl in _CLEANUP:
        text = pattern.sub(repl, text)
    for pattern, unit in _CURRENCY:
        text = pattern.sub(
            lambda m, u=unit: " "
            + number_to_words(m.group(1) + (m.group(2) or ""))
            + f" {u} ",
            text,
        )
    text = _ORDINAL.sub(lambda m: " " + _ordinal_words(int(m.group(1))) + " ", text)
    text = _YEAR.sub(lambda m: " " + _year_to_words(int(m.group(1))) + " ", text)
    text = _NUMBER.sub(lambda m: " " + number_to_words(m.group(0)) + " ", text)
    return re.sub(r"\s+", " ", text).strip()


_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "hon", "st", "jr", "sr", "vs",
    "etc", "e.g", "i.e", "inc", "ltd", "co", "corp", "mt", "ft", "gen",
    "col", "capt", "lt", "sgt", "no", "vol", "pp", "ch", "fig", "al",
}

_SENT_END = re.compile(r"([.!?…]+)(['\"”’)]*)\s+")


def split_sentences(text: str) -> List[str]:
    """Abbreviation-aware sentence splitting (replaces nltk Punkt)."""
    sentences = []
    start = 0
    for match in _SENT_END.finditer(text):
        end = match.end()
        before = text[start:match.start()].rstrip()
        last_word = before.rpartition(" ")[2].rstrip(".").lower()
        if match.group(1).startswith(".") and (
            last_word in _ABBREV or (len(last_word) == 1 and last_word.isalpha())
        ):
            continue
        sentence = text[start:end].strip()
        if sentence:
            sentences.append(sentence)
        start = end
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences

"""Phoneme error rate of the rule G2P and the homograph A/B.

    python -m stylish_tts_tpu_torch.scripts.g2p_eval [--out f.json] [--data DIR] [--regen-golden]

The figures come from three files of ``tests/data`` (or ``--data``):
  * ``cmudict_arpabet_1k.tsv``: CMUdict-0.7b-derived ARPAbet entries,
    turned into IPA mechanically (``arpabet_to_ipa``); hypothesis and gold
    both pass the convention-collapsing ``normalize`` (flap, rhotic-vowel
    and length merges) before scoring;
  * ``heteronym_sentences_external.tsv``: disambiguation cases from a
    public heteronym passage and the Wikipedia heteronym list, graded as
    noun or verb column choices, with an A/B between the rule scorer and
    the learned classifier (``textfrontend/homograph_model.py``);
  * ``g2p_golden.tsv``: a hand-authored golden in espeak-ng's en-us
    conventions, a secondary figure; ``--regen-golden`` rewrites it from
    an ``espeak-ng`` or ``espeak`` binary on the path, and raises without
    one.

The report, one JSON line (and ``--out``'s file), gives the full
pipeline's PER (lexicon and rules, what users get), the rules alone (every
word through ``letter_to_sound``, the quality for words out of the
lexicon) and the homograph accuracies.  Host code only.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
GOLDEN = "g2p_golden.tsv"
CMU_GOLDEN = "cmudict_arpabet_1k.tsv"
EXTERNAL_HOMOGRAPHS = "heteronym_sentences_external.tsv"

# ARPAbet -> IPA (espeak-en-us-adjacent symbol choices; exact convention
# differences are collapsed by normalize() on both sides anyway)
_ARPA_VOWELS = {
    "AA": "ɑ", "AE": "æ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ", "EH": "ɛ",
    "ER": "ɜ", "EY": "eɪ", "IH": "ɪ", "IY": "i", "OW": "oʊ", "OY": "ɔɪ",
    "UH": "ʊ", "UW": "u",
}
_ARPA_CONS = {
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(arpa: str) -> str:
    """Mechanical CMUdict ARPAbet -> IPA.  Stress marks land directly
    before the vowel (espeak puts them at syllable onset — the marked-PER
    column therefore over-counts by position; per_no_marks is primary)."""
    out = []
    for phone in arpa.split():
        stress = ""
        if phone[-1].isdigit():
            stress = {"1": "ˈ", "2": "ˌ"}.get(phone[-1], "")
            digit, phone = phone[-1], phone[:-1]
            if phone == "AH":
                out.append(stress + ("ə" if digit == "0" else "ʌ"))
                continue
            out.append(stress + _ARPA_VOWELS[phone])
        else:
            out.append(_ARPA_CONS[phone])
    return "".join(out)


# convention collapse: applied to BOTH hypothesis and gold before the edit
# distance.  Multi-char units first (private-use placeholders), then the
# systematic espeak-vs-CMU merges: flap ɾ=t, ɐ=ə, ᵻ=ɪ, r-colored ɚ/ɝ=ɜ,
# lone o (espeak oːɹ) = ɔ, ascii g = ɡ.
_DIGRAPHS = [
    ("t\u0283", "\ue000"), ("d\u0292", "\ue001"), ("a\u028a", "\ue002"),
    ("a\u026a", "\ue003"), ("e\u026a", "\ue004"), ("\u0254\u026a", "\ue005"),
    ("o\u028a", "\ue006"),
]
_MERGES = str.maketrans({
    "ɾ": "t", "ɐ": "ə", "ᵻ": "ɪ", "ɚ": "ɜ", "ɝ": "ɜ", "o": "ɔ",
    "g": "ɡ", "r": "ɹ", "ʴ": None,
})


def normalize(ipa: str) -> str:
    s = ipa.translate(STRIP_MARKS)
    for pat, repl in _DIGRAPHS:
        s = s.replace(pat, repl)
    return s.translate(_MERGES)

# (sentence, target word, expected IPA) — heteronyms in disambiguating
# context; expected column from the lexicon the reference disambiguates
# into (lib/ttab/homographs.py)
HOMOGRAPH_SENTENCES = [
    ("She will read the book tonight", "read", "ɹiːd"),
    ("He had read the letter twice", "read", "ɹɛd"),
    ("The lead pipe was heavy", "lead", "lɛd"),
    ("They will lead the parade", "lead", "liːd"),
    ("A gust of wind shook the tent", "wind", "wɪnd"),
    ("Please wind the clock", "wind", "waɪnd"),
    ("He took a bow after the show", "bow", "baʊ"),
    ("She tied the bow on the gift", "bow", "boʊ"),
    ("A tear rolled down her cheek", "tear", "tɪɹ"),
    ("Do not tear the paper", "tear", "tɛɹ"),
    ("Please close the door", "close", "kloʊz"),
    ("The store is close to home", "close", "kloʊs"),
    ("What is the use of it", "use", "juːs"),
    ("You can use my pen", "use", "juːz"),
    ("The soldier was wounded", "wounded", "wuːndɪd"),
    ("They live in the city", "live", "lɪv"),
    ("The show was live music", "live", "laɪv"),
    ("Wait a minute please", "minute", "mˈɪnɪt"),
    ("He kept a record of it", "record", "ɹˈɛkɚd"),
    ("They record a song every day", "record", "ɹɪkˈoːɹd"),
    ("The desert was hot and dry", "desert", "dˈɛzɚt"),
    ("Do not desert your post", "desert", "dɪzˈɜːt"),
    ("A strange object appeared", "object", "ˈɑːbdʒɛkt"),
    ("They object to the plan", "object", "əbdʒˈɛkt"),
    ("The present was wrapped in paper", "present", "pɹˈɛzənt"),
    ("They present the award tonight", "present", "pɹɪzˈɛnt"),
    ("You need a permit to park", "permit", "pˈɜːmɪt"),
    ("They permit us to enter", "permit", "pɚmˈɪt"),
    ("The contest begins at noon", "contest", "kˈɑːntɛst"),
    ("Fresh produce from the farm", "produce", "pɹˈoʊduːs"),
    ("The factories produce steel", "produce", "pɹədˈuːs"),
    ("He is a suspect in the case", "suspect", "sˈʌspɛkt"),
    ("I suspect she is right", "suspect", "səspˈɛkt"),
    ("This is a separate room", "separate", "sˈɛpəɹət"),
    ("Please separate the eggs", "separate", "sˈɛpəɹˌeɪt"),
    ("He is a graduate of the school", "graduate", "ˈɡɹædʒuət"),
    ("She will graduate in June", "graduate", "ˈɡɹædʒuˌeɪt"),
]

STRIP_MARKS = str.maketrans("", "", "ˈˌː ")


def edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(
                prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)
            ))
        prev = cur
    return prev[-1]


def per(pairs, collapse=False) -> dict:
    """{phoneme error rates} over (pred, gold) pairs.  collapse=True runs
    both sides through the convention-collapsing normalize() (used for
    CMU-derived golds, where marked-PER is position-biased by design)."""
    out = {}
    if not collapse:
        dist = sum(edit_distance(p, g) for p, g in pairs)
        total = sum(len(g) for _, g in pairs)
        out["per"] = round(dist / max(total, 1), 4)
    norm = normalize if collapse else (
        lambda s: s.translate(STRIP_MARKS)
    )
    stripped = [(norm(p), norm(g)) for p, g in pairs]
    dist_ns = sum(edit_distance(p, g) for p, g in stripped)
    total_ns = sum(len(g) for _, g in stripped)
    exact = sum(p == g for p, g in stripped)
    out.update({
        "per_no_marks": round(dist_ns / max(total_ns, 1), 4),
        "word_accuracy_no_marks": round(exact / max(len(pairs), 1), 4),
        "words": len(pairs),
    })
    return out


def eval_external_homographs(g2p, data: Path = DATA) -> dict:
    """A/B the rule scorer vs the learned classifier on the external
    disambiguation set; grades noun/verb column choices."""
    from ..textfrontend.homograph_model import LearnedHomographClassifier
    from ..textfrontend.homographs import Homographs

    heur = Homographs()
    learned = Homographs(classifier=LearnedHomographClassifier.load())

    rows = [
        line.split("\t")
        for line in (data / EXTERNAL_HOMOGRAPHS).read_text().splitlines()
        if line.strip() and not line.startswith("#")
    ]
    occ_counter: dict = {}
    cases, uncovered = [], 0
    for sentence, word, col, source in rows:
        key = (sentence, word)
        occ = occ_counter.get(key, 0)
        occ_counter[key] = occ + 1
        toks = sentence.split()
        positions = [
            i for i, t in enumerate(toks)
            if t.lower() == word or heur._stem(t.lower())[0] == word
        ]
        if occ >= len(positions):
            raise ValueError(f"occurrence {occ} of {word!r} not found: "
                             f"{sentence!r}")
        i = positions[occ]
        if not heur.is_homograph(toks[i]):
            uncovered += 1
            continue
        expected = {"n": 0, "v": 1}[col]
        left, right = toks[max(0, i - 3):i], toks[i + 1:i + 3]
        cases.append((toks[i], left, right, expected))

    res = {}
    for name, mech in (("heuristic", heur), ("learned", learned)):
        hits = sum(
            mech.choose(w, l, r) == exp for w, l, r, exp in cases
        )
        res[name + "_accuracy"] = round(hits / max(len(cases), 1), 4)
    res.update({
        "cases": len(cases),
        "uncovered_stems": uncovered,
        "source": "public heteronym passage + wikipedia heteronym list "
                  "(tests/data/heteronym_sentences_external.tsv)",
    })
    return res


def regen_golden(words, data: Path = DATA) -> None:
    """Rewrite the hand-authored golden from an espeak binary's IPA."""
    espeak = shutil.which("espeak-ng") or shutil.which("espeak")
    if not espeak:
        raise SystemExit("--regen-golden requires an espeak binary")
    lines = []
    for w in words:
        out = subprocess.run(
            [espeak, "-q", "--ipa=3", "-v", "en-us", w],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().replace("_", "")
        lines.append(f"{w}\t{out}")
    (data / GOLDEN).write_text("\n".join(lines) + "\n")


def _golden_rows(data: Path) -> list:
    return [
        line.split("\t")
        for line in (data / GOLDEN).read_text().splitlines()
        if line.strip() and not line.startswith("#")
    ]


def evaluate(data: Path = DATA) -> dict:
    """The report on the three files in ``data``."""
    from ..textfrontend.g2p import G2P, LEXICON, add_stress, letter_to_sound

    data = Path(data)
    rows = _golden_rows(data)
    g2p = G2P(use_espeak=False)

    # primary: the CMUdict-derived golden (independent of the rules' author)
    seen = set()
    cmu_rows = []
    for line in (data / CMU_GOLDEN).read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        word, arpa = line.split("\t")
        if word in seen:
            continue
        seen.add(word)
        cmu_rows.append((word, arpabet_to_ipa(arpa)))
    cmu_full = [(g2p.word(w), gold) for w, gold in cmu_rows]
    cmu_rules = [
        (add_stress(letter_to_sound(w.lower())), gold) for w, gold in cmu_rows
    ]
    cmu_oov = [
        (g2p.word(w), gold) for w, gold in cmu_rows
        if w.lower() not in LEXICON
    ]

    # secondary: the hand-authored espeak-convention golden
    full, rules_only, oov = [], [], []
    for word, gold in rows:
        full.append((g2p.word(word), gold))
        rules = add_stress(letter_to_sound(word.lower()))
        rules_only.append((rules, gold))
        if word.lower() not in LEXICON:
            oov.append((g2p.word(word), gold))

    hits = 0
    for sentence, target, expected in HOMOGRAPH_SENTENCES:
        toks = sentence.split()
        i = toks.index(target)
        got = g2p.homographs.resolve(target, toks[max(0, i - 3):i],
                                     toks[i + 1:i + 3])
        hits += got == expected
    return {
        "cmudict_derived": {
            "golden_source": "cmudict 0.7b primary pronunciations "
                             "(tests/data/cmudict_arpabet_1k.tsv), IPA "
                             "derived mechanically, convention-collapsed "
                             "both sides",
            "full_pipeline": per(cmu_full, collapse=True),
            "rules_only": per(cmu_rules, collapse=True),
            "out_of_lexicon": per(cmu_oov, collapse=True),
        },
        "external_homographs": eval_external_homographs(g2p, data),
        "hand_authored": {
            "golden_source": "hand-authored espeak-ng en-us conventions "
                             "(no espeak binary in image)",
            "full_pipeline": per(full),
            "rules_only": per(rules_only),
            "out_of_lexicon": per(oov),
            "homograph_accuracy": round(
                hits / len(HOMOGRAPH_SENTENCES), 4
            ),
            "homograph_sentences": len(HOMOGRAPH_SENTENCES),
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--data", default=str(DATA),
                    help="directory of the three TSV files")
    ap.add_argument("--regen-golden", action="store_true")
    args = ap.parse_args(argv)
    data = Path(args.data)
    if args.regen_golden:
        regen_golden([w for w, _ in _golden_rows(data)], data)
        return 0
    report = evaluate(data)
    print(json.dumps(report))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

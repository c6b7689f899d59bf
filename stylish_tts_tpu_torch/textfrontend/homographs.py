"""Homograph disambiguation.

The reference resolves homographs with ModernBERT embeddings + per-word
sklearn classifiers + spacy POS tags (lib/ttab/homographs.py:17-40) — all
requiring downloads an air-gapped pod can't make.  This module provides the
same capability with a self-contained mechanism:

* a heteronym lexicon of ~85 English words whose pronunciation depends on
  part of speech (stress-shift noun/verb pairs, ``-ate`` noun-adjective vs
  verb endings, and vowel-quality pairs like read/lead/wind/tear);
* a lightweight contextual POS scorer over the neighbouring tokens
  (determiner / modal / pronoun / preposition / intensifier cue classes,
  adverb suffixes, object-slot look-ahead, per-word priors);
* inflection handling — ``records``, ``recorded``, ``recording`` resolve
  the stem and re-apply the suffix with English voicing rules, with the
  ``-ed``/``-ing`` morphology itself forcing the verb reading.

A learned disambiguator can be slotted in later via ``Homographs.resolve``'s
classifier hook.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# word -> (noun/adjective IPA, verb IPA)
HOMOGRAPHS: Dict[str, Tuple[str, str]] = {
    # -- vowel-quality pairs ------------------------------------------- #
    "read": ("ɹɛd", "ɹiːd"),          # past vs present resolved separately
    "lead": ("lɛd", "liːd"),
    "live": ("laɪv", "lɪv"),
    "wind": ("wɪnd", "waɪnd"),
    "bow": ("boʊ", "baʊ"),
    "tear": ("tɪɹ", "tɛɹ"),
    "close": ("kloʊs", "kloʊz"),
    "use": ("juːs", "juːz"),
    "abuse": ("əbjˈuːs", "əbjˈuːz"),
    "excuse": ("ɪkskjˈuːs", "ɪkskjˈuːz"),
    "house": ("haʊs", "haʊz"),
    "sow": ("saʊ", "soʊ"),            # the pig vs to plant seed
    "dove": ("dˈʌv", "doʊv"),
    "wound": ("wuːnd", "waʊnd"),
    "minute": ("mˈɪnɪt", "maɪnˈuːt"),
    "invalid": ("ˈɪnvəlɪd", "ɪnvˈælɪd"),
    # -- stress-shift noun/verb pairs ---------------------------------- #
    "addict": ("ˈædɪkt", "ədˈɪkt"),
    "address": ("ˈædɹɛs", "ədɹˈɛs"),
    "combat": ("kˈɑːmbæt", "kəmbˈæt"),
    "compound": ("kˈɑːmpaʊnd", "kəmpˈaʊnd"),
    "compress": ("kˈɑːmpɹɛs", "kəmpɹˈɛs"),
    "conduct": ("kˈɑːndʌkt", "kəndˈʌkt"),
    "conflict": ("kˈɑːnflɪkt", "kənflˈɪkt"),
    "conscript": ("kˈɑːnskɹɪpt", "kənskɹˈɪpt"),
    "console": ("kˈɑːnsoʊl", "kənsˈoʊl"),
    "consort": ("kˈɑːnsoːɹt", "kənsˈoːɹt"),
    "construct": ("kˈɑːnstɹʌkt", "kənstɹˈʌkt"),
    "content": ("kˈɑːntɛnt", "kəntˈɛnt"),
    "contest": ("kˈɑːntɛst", "kəntˈɛst"),
    "contract": ("kˈɑːntɹækt", "kəntɹˈækt"),
    "contrast": ("kˈɑːntɹæst", "kəntɹˈæst"),
    "convert": ("kˈɑːnvɜːt", "kənvˈɜːt"),
    "convict": ("kˈɑːnvɪkt", "kənvˈɪkt"),
    "decrease": ("dˈiːkɹiːs", "dɪkɹˈiːs"),
    "defect": ("dˈiːfɛkt", "dɪfˈɛkt"),
    "desert": ("dˈɛzɚt", "dɪzˈɜːt"),
    "digest": ("dˈaɪdʒɛst", "daɪdʒˈɛst"),
    "discharge": ("dˈɪstʃɑːɹdʒ", "dɪstʃˈɑːɹdʒ"),
    "discount": ("dˈɪskaʊnt", "dɪskˈaʊnt"),
    "escort": ("ˈɛskoːɹt", "ɛskˈoːɹt"),
    "exploit": ("ˈɛksplɔɪt", "ɛksplˈɔɪt"),
    "export": ("ˈɛkspoːɹt", "ɛkspˈoːɹt"),
    "extract": ("ˈɛkstɹækt", "ɛkstɹˈækt"),
    "impact": ("ˈɪmpækt", "ɪmpˈækt"),
    "implant": ("ˈɪmplænt", "ɪmplˈænt"),
    "import": ("ˈɪmpoːɹt", "ɪmpˈoːɹt"),
    "imprint": ("ˈɪmpɹɪnt", "ɪmpɹˈɪnt"),
    "incense": ("ˈɪnsɛns", "ɪnsˈɛns"),
    "incline": ("ˈɪnklaɪn", "ɪnklˈaɪn"),
    "increase": ("ˈɪnkɹiːs", "ɪnkɹˈiːs"),
    "insert": ("ˈɪnsɜːt", "ɪnsˈɜːt"),
    "insult": ("ˈɪnsʌlt", "ɪnsˈʌlt"),
    "object": ("ˈɑːbdʒɛkt", "əbdʒˈɛkt"),
    "perfume": ("pˈɜːfjuːm", "pɚfjˈuːm"),
    "permit": ("pˈɜːmɪt", "pɚmˈɪt"),
    "pervert": ("pˈɜːvɜːt", "pɚvˈɜːt"),
    "present": ("pɹˈɛzənt", "pɹɪzˈɛnt"),
    "produce": ("pɹˈoʊduːs", "pɹədˈuːs"),
    "progress": ("pɹˈɑːɡɹɛs", "pɹəɡɹˈɛs"),
    "project": ("pɹˈɑːdʒɛkt", "pɹədʒˈɛkt"),
    "protest": ("pɹˈoʊtɛst", "pɹətˈɛst"),
    "rebel": ("ɹˈɛbəl", "ɹɪbˈɛl"),
    "recall": ("ɹˈiːkɔːl", "ɹɪkˈɔːl"),
    "record": ("ɹˈɛkɚd", "ɹɪkˈoːɹd"),
    "recount": ("ɹˈiːkaʊnt", "ɹɪkˈaʊnt"),
    "refill": ("ɹˈiːfɪl", "ɹɪfˈɪl"),
    "refund": ("ɹˈiːfʌnd", "ɹɪfˈʌnd"),
    "refuse": ("ɹˈɛfjuːs", "ɹɪfjˈuːz"),
    "reject": ("ɹˈiːdʒɛkt", "ɹɪdʒˈɛkt"),
    "research": ("ɹˈiːsɜːtʃ", "ɹɪsˈɜːtʃ"),
    "segment": ("sˈɛɡmənt", "sɛɡmˈɛnt"),
    "subject": ("sˈʌbdʒɛkt", "səbdʒˈɛkt"),
    "survey": ("sˈɜːveɪ", "sɚvˈeɪ"),
    "suspect": ("sˈʌspɛkt", "səspˈɛkt"),
    "torment": ("tˈoːɹmɛnt", "toːɹmˈɛnt"),
    "transfer": ("tɹˈænsfɚ", "tɹænsfˈɜː"),
    "transplant": ("tɹˈænsplænt", "tɹænsplˈænt"),
    "transport": ("tɹˈænspoːɹt", "tɹænspˈoːɹt"),
    "upgrade": ("ˈʌpɡɹeɪd", "ʌpɡɹˈeɪd"),
    "upset": ("ˈʌpsɛt", "ʌpsˈɛt"),
    # -- -ate noun/adjective (/ət/) vs verb (/eɪt/) pairs --------------- #
    "advocate": ("ˈædvəkət", "ˈædvəkˌeɪt"),
    "aggregate": ("ˈæɡɹɪɡət", "ˈæɡɹɪɡˌeɪt"),
    "alternate": ("ˈɔːltɚnət", "ˈɔːltɚnˌeɪt"),
    "animate": ("ˈænɪmət", "ˈænɪmˌeɪt"),
    "appropriate": ("əpɹˈoʊpɹiət", "əpɹˈoʊpɹiˌeɪt"),
    "approximate": ("əpɹˈɑːksɪmət", "əpɹˈɑːksɪmˌeɪt"),
    "articulate": ("ɑːɹtˈɪkjʊlət", "ɑːɹtˈɪkjʊlˌeɪt"),
    "associate": ("əsˈoʊʃiət", "əsˈoʊʃiˌeɪt"),
    "coordinate": ("koʊˈoːɹdɪnət", "koʊˈoːɹdɪnˌeɪt"),
    "delegate": ("dˈɛlɪɡət", "dˈɛlɪɡˌeɪt"),
    "deliberate": ("dɪlˈɪbəɹət", "dɪlˈɪbəɹˌeɪt"),
    "duplicate": ("dˈuːplɪkət", "dˈuːplɪkˌeɪt"),
    "elaborate": ("ɪlˈæbəɹət", "ɪlˈæbəɹˌeɪt"),
    "estimate": ("ˈɛstɪmət", "ˈɛstɪmˌeɪt"),
    "graduate": ("ˈɡɹædʒuət", "ˈɡɹædʒuˌeɪt"),
    "intimate": ("ˈɪntɪmət", "ˈɪntɪmˌeɪt"),
    "moderate": ("mˈɑːdəɹət", "mˈɑːdəɹˌeɪt"),
    "predicate": ("pɹˈɛdɪkət", "pɹˈɛdɪkˌeɪt"),
    "separate": ("sˈɛpəɹət", "sˈɛpəɹˌeɪt"),
    "subordinate": ("səbˈoːɹdɪnət", "səbˈoːɹdɪnˌeɪt"),
    "syndicate": ("sˈɪndɪkət", "sˈɪndɪkˌeɪt"),
}

# words that lean noun/adjective when context gives no signal
_NOUN_PRIOR = {
    "minute", "house", "record", "desert", "object", "subject", "content",
    "present", "project", "permit", "console", "perfume", "incense",
    "segment", "syndicate", "predicate", "dove", "wound",
    "appropriate", "approximate", "intimate", "separate", "deliberate",
    "elaborate", "moderate", "alternate", "aggregate", "invalid",
}

_DETERMINERS = {
    "a", "an", "the", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their", "no", "every", "each", "some",
    "any", "another", "such", "whose", "what", "which",
}
_INTENSIFIERS = {
    "very", "quite", "so", "too", "more", "most", "rather", "pretty",
    "really", "fairly", "how",
}
_MODALS = {
    "will", "would", "can", "could", "may", "might", "shall", "should",
    "must", "do", "does", "did", "don't", "doesn't", "didn't", "won't",
    "can't", "couldn't", "wouldn't", "shouldn't", "to", "let's", "please",
    "help", "gonna", "not",
}
_SUBJECT_PRONOUNS = {"i", "we", "they", "you", "he", "she", "who"}
_PREPOSITIONS = {
    "of", "in", "on", "at", "for", "with", "by", "from", "about", "over",
    "under", "into", "during", "without", "against", "between", "through",
    "per",
}
_OBJECT_NEXT = {
    "the", "a", "an", "it", "them", "me", "him", "us", "your", "my",
    "his", "her", "our", "their", "this", "that", "these", "those",
    "yourself", "himself", "herself", "themselves", "myself",
}
_PAST_CUES = {"had", "has", "have", "was", "were", "been", "already",
              "yesterday", "just"}

# Tense-pair stems whose -ed/-ing form belongs to the *noun/adjective*
# column, because the verb column holds a different lexeme's form:
# 'wounded' is to-wound (/wuːnd/), not the past of to-wind (/waʊnd/);
# 'leaded' (glass, gasoline) is /lɛdɪd/; 'winded' (out of breath) is
# /wɪndɪd/.  The forced-verb inflection rule must not apply to these.
_TENSE_PAIR_INFLECTIONS: Dict[Tuple[str, str], int] = {
    ("wound", "ed"): 0,
    ("wound", "ing"): 0,
    ("lead", "ed"): 0,
    ("wind", "ed"): 0,
}

_VOICELESS = set("ptkfθsʃtʃ")


def _append_s(ipa: str) -> str:
    if ipa[-1] in "sʃzʒ" or ipa.endswith(("tʃ", "dʒ")):
        return ipa + "əz"
    if ipa[-1] in _VOICELESS:
        return ipa + "s"
    return ipa + "z"


def _append_ed(ipa: str) -> str:
    if ipa[-1] in "td":
        return ipa + "ɪd"
    if ipa[-1] in _VOICELESS:
        return ipa + "t"
    return ipa + "d"


def _verb_score(word: str, left: List[str], right: List[str]) -> float:
    """Positive → verb reading, negative → noun/adjective reading."""
    score = -0.5 if word in _NOUN_PRIOR else 0.0
    prev = [w.lower() for w in left if w and w[0].isalpha()][-3:]
    nxt = [w.lower() for w in right if w and w[0].isalpha()][:2]
    if prev:
        last = prev[-1]
        if last in _DETERMINERS:
            score -= 3.0
        elif last in _INTENSIFIERS:
            score -= 2.0
        elif last in _PREPOSITIONS:
            score -= 2.0
        elif last in _MODALS:
            score += 3.0
        elif last in _SUBJECT_PRONOUNS:
            score += 2.5
        elif last.endswith("ly"):
            score += 1.0
        if any(w in _MODALS for w in prev[:-1]):
            score += 0.75
        if any(w in _SUBJECT_PRONOUNS for w in prev[:-1]):
            score += 0.5
    if nxt:
        if nxt[0] in _OBJECT_NEXT:
            score += 1.5
        if nxt[0] in _PREPOSITIONS:
            score -= 0.25  # "record of", "use of" — noun-ish attachment
    return score


class Homographs:
    def __init__(self, classifier=None):
        """``classifier(word, left_context, right_context) -> 0|1`` picks
        the (noun, verb) entry; defaults to the rule-based scorer."""
        self.classifier = classifier

    def is_homograph(self, word: str) -> bool:
        return self._stem(word.lower())[0] is not None

    @staticmethod
    def _stem(lower: str) -> Tuple[Optional[str], str]:
        """Return (lexicon stem, suffix in {'', 's', 'ed', 'ing'})."""
        if lower in HOMOGRAPHS:
            return lower, ""
        if lower.endswith("s") and lower[:-1] in HOMOGRAPHS:
            return lower[:-1], "s"
        for suf in ("ed", "ing"):
            if not lower.endswith(suf):
                continue
            stem = lower[: -len(suf)]
            if stem in HOMOGRAPHS:
                return stem, suf
            if stem + "e" in HOMOGRAPHS:  # used → use, closing → close
                return stem + "e", suf
        return None, ""

    def choose(
        self, word: str, left: List[str], right: List[str]
    ) -> Optional[int]:
        """Column decision only: 0 = noun/adjective, 1 = verb (None if the
        word is not in the heteronym lexicon).  Shared by ``resolve`` and
        the external A/B harness (scripts/g2p_eval.py)."""
        stem, suffix = self._stem(word.lower())
        if stem is None:
            return None
        if suffix in ("ed", "ing"):
            # the morphology itself disambiguates: only verbs inflect —
            # except the tense-pair stems, where the inflected form is the
            # OTHER column's lexeme (wounded, leaded, winded)
            return _TENSE_PAIR_INFLECTIONS.get((stem, suffix), 1)
        if stem == "read":
            # tense, not POS: past /ɹɛd/ vs present /ɹiːd/.  A 3sg '-s'
            # grammatically excludes past tense, so 'reads' is always
            # present regardless of past cues in context.
            if suffix == "s":
                return 1
            prev = [w.lower() for w in left[-2:]]
            return 0 if any(w in _PAST_CUES for w in prev) else 1
        if self.classifier is not None:
            return int(self.classifier(stem, left, right))
        return 1 if _verb_score(stem, left, right) > 0 else 0

    def resolve(
        self, word: str, left: List[str], right: List[str]
    ) -> Optional[str]:
        stem, suffix = self._stem(word.lower())
        if stem is None:
            return None
        noun_ipa, verb_ipa = HOMOGRAPHS[stem]
        if stem == "house" and suffix == "s":
            # irregular stem voicing: plural noun AND 3sg verb are /haʊzəz/
            return "haʊzəz"
        ipa = (noun_ipa, verb_ipa)[self.choose(word, left, right)]
        if suffix == "s":
            return _append_s(ipa)
        if suffix == "ed":
            return _append_ed(ipa)
        if suffix == "ing":
            base = ipa[:-1] if ipa.endswith("ə") else ipa
            return base + "ɪŋ"
        return ipa

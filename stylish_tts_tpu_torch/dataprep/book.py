"""Audiobook -> training-dataset construction (ttab dataprep parity); the
port's copy of the JAX package's ``dataprep/book.py``.

Capability counterpart of the reference's audiobook tooling
(`train/dataprep/ttab/{find-phrases,transcribe-phrases,
match-transcriptions,make-segments}.py`), re-designed for this framework:

* **Phrase segmentation** — reference: pydub silence detection.  Here:
  a vectorised frame-RMS detector with hysteresis (numpy; no external
  audio stack), returning phrase (start, end) sample ranges.
* **Transcript matching** — reference: whisper/speechbrain ASR per phrase
  fuzzy-matched against the book text with `difflib.SequenceMatcher`
  over espeak phonemizations (match-transcriptions.py:12-72).  Here: the
  same longest-match algorithm over the built-in G2P's phoneme strings
  (textfrontend.G2P), consuming transcripts from ANY ASR the user runs
  (`phrase|start|end|text` lists, the reference's interchange format).
  Punctuation-growing of matched spans reproduces grow_tokens
  (match-transcriptions.py:54-72).
* **Transcript-free path** — this framework's own aligner replaces the
  ASR stage entirely when the book text is known: phrases are matched
  greedily by CTC alignment score against candidate book windows
  (`score_phrase`), using the trained TextAligner + ops.ctc.forced_align
  — the tool the reference lacked (its ASR+fuzzy-match pipeline exists
  precisely because it had no long-audio aligner).
* **Segment building** — reference: make-segments.py cuts ~10 s
  (gauss(10, 5)) multi-phrase segments between 1-20 s, phonemizes, writes
  duration-bucketed train lists + a 3% val split.  Same policy here
  (seeded RNG instead of global random), emitting the
  `file|phonemes|speaker|text` lines the trainer, `pitch` and `align`
  read (``data/dataset.py``).  The JAX package writes `file|phonemes|0`,
  three fields, which its own dataset rejects and its `pitch` and `align`
  skip; the port adds the segment's text as the fourth.

Driven by ``python -m stylish_tts_tpu_torch.cli prepare-book``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from difflib import SequenceMatcher
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"[A-Za-z']+")
_STRESS = str.maketrans("", "", "\u02c8\u02cc")  # primary/secondary stress


def _phoneme_key(g2p, word: str) -> str:
    """Matcher key: stress-stripped phonemes, so homophone-level ASR
    differences (two/too) and stress-position conventions both match."""
    return g2p.word(word).translate(_STRESS)
_JUNK_STRIP = "1234567890,.;:-?!'\"()$%—“”‘’"


# --------------------------------------------------------------------- #
# 1. Phrase segmentation (find-phrases.py counterpart)
# --------------------------------------------------------------------- #


def detect_phrases(
    audio: np.ndarray,
    sample_rate: int,
    *,
    frame_ms: float = 20.0,
    min_silence_ms: float = 350.0,
    min_phrase_ms: float = 400.0,
    max_phrase_s: float = 30.0,
    threshold_db: float = -38.0,
    pad_ms: float = 60.0,
) -> List[Tuple[int, int]]:
    """Split mono audio into phrase (start, end) sample ranges at
    silences.  Frame RMS (`frame_ms` windows) is compared against
    `threshold_db` relative to the 95th-percentile loudness; runs of
    quiet frames >= `min_silence_ms` split phrases; phrases longer than
    `max_phrase_s` are force-split at their quietest interior frame
    (reference skips >30 s phrases outright — find-phrases.py:40-48)."""
    frame = max(1, int(sample_rate * frame_ms / 1000.0))
    n = len(audio) // frame
    if n == 0:
        return []
    rms = np.sqrt(
        np.mean(audio[: n * frame].reshape(n, frame).astype(np.float64) ** 2,
                axis=1) + 1e-12
    )
    loud_ref = np.percentile(rms, 95) + 1e-12
    level_db = 20.0 * np.log10(rms / loud_ref)
    quiet = level_db < threshold_db

    min_sil = max(1, int(min_silence_ms / frame_ms))
    phrases: List[Tuple[int, int]] = []
    start = None
    run = 0
    for i, q in enumerate(np.append(quiet, True)):
        if not q:
            if start is None:
                start = i
            run = 0
        else:
            run += 1
            if start is not None and run >= min_sil:
                phrases.append((start, i - run + 1))
                start = None
    if start is not None:
        phrases.append((start, n))

    # force-split over-long phrases at their quietest interior frame
    max_frames = int(max_phrase_s * 1000.0 / frame_ms)
    split: List[Tuple[int, int]] = []
    stack = list(reversed(phrases))
    while stack:
        s, e = stack.pop()
        if e - s > max_frames:
            interior = level_db[s + min_sil: e - min_sil]
            if interior.size:
                cut = s + min_sil + int(np.argmin(interior))
                stack.append((cut, e))
                stack.append((s, cut))
                continue
        split.append((s, e))

    pad = int(pad_ms / frame_ms)
    min_phrase = max(1, int(min_phrase_ms / frame_ms))
    out = []
    for s, e in split:
        if e - s < min_phrase:
            continue
        out.append((max(0, s - pad) * frame, min(n, e + pad) * frame))
    return out


# --------------------------------------------------------------------- #
# 2. Book text tokenization + transcript matching
#    (match-transcriptions.py counterpart)
# --------------------------------------------------------------------- #


def _is_junk(word: str) -> bool:
    return word.strip(_JUNK_STRIP) == ""


@dataclass
class BookText:
    """Tokenized book with the clean(word)->raw token index maps the
    matcher needs to grow matched spans back over punctuation."""

    raw_tokens: List[str]
    clean_keys: List[str]
    clean_to_start: List[int]
    clean_to_end: List[int]


def tokenize_book(text: str, g2p=None) -> BookText:
    raw = text.split()
    clean_keys: List[str] = []
    starts: List[int] = []
    ends: List[int] = []
    for i, tok in enumerate(raw):
        if _is_junk(tok):
            continue
        word = tok.strip(_JUNK_STRIP).lower()
        key = _phoneme_key(g2p, word) if g2p is not None else word
        clean_keys.append(key)
        starts.append(i)
        ends.append(i + 1)
    return BookText(raw, clean_keys, starts, ends)


class TranscriptMatcher:
    """Greedy in-order longest-match of phrase transcripts against the
    book, over phoneme keys (reference Chapter.match_next,
    match-transcriptions.py:39-52).  Matching in phoneme space absorbs
    spelling/ASR orthography differences exactly as the reference's
    espeak phonemization did."""

    def __init__(self, book_text: str, g2p=None):
        if g2p is None:
            from ..textfrontend import G2P

            g2p = G2P()
        self.g2p = g2p
        self.book = tokenize_book(book_text, g2p)
        self.matcher = SequenceMatcher(autojunk=False)
        self.matcher.set_seq1(self.book.clean_keys)
        self.next_start = 0

    def match_next(self, transcript: str) -> Optional[str]:
        """Ground-truth book phrase for one ASR transcript, or None when
        no full-length match exists past the reading cursor."""
        words = [w.lower() for w in _WORD_RE.findall(transcript)]
        keys = [_phoneme_key(self.g2p, w) for w in words if not _is_junk(w)]
        if not keys:
            return None
        self.matcher.set_seq2(keys)
        match = self.matcher.find_longest_match(
            self.next_start, len(self.book.clean_keys), 0, len(keys)
        )
        if match.size < len(keys) or match.size == 0:
            return None
        self.next_start = match.a + match.size
        return " ".join(self._grow(match.a, match.a + match.size)).strip()

    def _grow(self, begin: int, end: int) -> List[str]:
        # re-attach leading/trailing punctuation the clean tokens dropped
        # (reference grow_tokens, match-transcriptions.py:54-72)
        b = self.book.clean_to_start[begin]
        e = self.book.clean_to_end[end - 1]
        while b > 0 and self.book.raw_tokens[b - 1] in "\"'(“‘":
            b -= 1
        while e < len(self.book.raw_tokens) and (
            self.book.raw_tokens[e] in "\"'),.;:-?!”’"
        ):
            e += 1
        return self.book.raw_tokens[b:e]


def match_transcripts(
    phrases: Sequence[Tuple[int, int, Optional[str]]],
    book_text: str,
    g2p=None,
) -> List[Tuple[int, int, Optional[str]]]:
    """[(start, end, asr_text)] -> [(start, end, book_phrase_or_None)]."""
    matcher = TranscriptMatcher(book_text, g2p)
    out = []
    for start, end, text in phrases:
        gt = matcher.match_next(text) if text else None
        out.append((start, end, gt))
    return out


# --------------------------------------------------------------------- #
# 3. Transcript-free path: align book windows with the CTC aligner
# --------------------------------------------------------------------- #


class AlignerScorer:
    """Scores (phrase audio, candidate text) pairs with the trained
    aligner's per-frame CTC forced-alignment score — the framework-native
    replacement for the reference's external-ASR stage.  The mel (through
    the STFT kernel), the aligner and the Viterbi run on ``device`` (the
    card unless named).  Only the aligner's parameters are loaded: its
    batch norms keep their initial stats (mean 0, variance 1), as the JAX
    package's scorer leaves them."""

    def __init__(self, model_config, aligner_weights: str, device=None):
        from ..device import resolve_device
        from ..models.text_aligner import (build_text_aligner,
                                           load_aligner_params)
        from ..ops.mel import MelSpectrogram
        from ..text import TextCleaner

        self.mc = model_config
        self.device = resolve_device(device)
        self.cleaner = TextCleaner()
        self.aligner = load_aligner_params(
            aligner_weights, build_text_aligner(model_config), self.device)
        self.to_mel = MelSpectrogram(
            n_mels=80, n_fft=model_config.n_fft,
            win_length=model_config.win_length,
            hop_length=model_config.hop_length,
            sample_rate=model_config.sample_rate,
        )

    def _run(self, wave, tokens, text_len, mel_len):
        import torch

        from ..ops.ctc import forced_align

        with torch.no_grad():
            mel = self.to_mel(wave)
            mel = (torch.log(1e-5 + mel) + 4.0) / 4.0
            mel = mel[:, :-1]
            log_probs, _ = self.aligner(mel, mel_len)
            _, scores = forced_align(
                log_probs, tokens, mel_len, text_len,
                self.mc.text_encoder.tokens,
            )
            return torch.sum(scores, dim=1)

    def score(self, audio: np.ndarray, text: str, g2p) -> float:
        """Mean per-frame forced-alignment log-probability (higher =
        better match); -inf when the text cannot be embedded."""
        import torch

        phonemes = g2p(text)
        ids = self.cleaner(phonemes)
        if not ids:
            return float("-inf")
        frames = len(audio) // self.mc.hop_length
        if frames < 4 or len(ids) * 2 + 1 > frames:
            return float("-inf")
        dev = self.device
        wave = torch.as_tensor(
            np.asarray(audio[: frames * self.mc.hop_length], np.float32),
            device=dev)[None]
        tokens = torch.as_tensor(np.asarray(ids, np.int64), device=dev)[None]
        s = self._run(wave, tokens, torch.tensor([len(ids)], device=dev),
                      torch.tensor([frames], device=dev))
        return float(s[0]) / max(frames, 1)


# --------------------------------------------------------------------- #
# 4. Segment building (make-segments.py counterpart)
# --------------------------------------------------------------------- #


def build_segments(
    phrases: Sequence[Tuple[int, int, Optional[str]]],
    sample_rate: int,
    *,
    rng: np.random.Generator,
    goal_mean_s: float = 10.0,
    goal_std_s: float = 5.0,
    min_s: float = 1.0,
    max_s: float = 20.0,
) -> List[Tuple[int, int, str]]:
    """Greedily merge consecutive matched phrases into ~N(10 s, 5 s)
    segments within [1 s, 20 s] (reference seek_audio,
    make-segments.py:53-86).  Unmatched phrases break the run."""
    out: List[Tuple[int, int, str]] = []
    i = 0
    while i < len(phrases):
        while i < len(phrases) and phrases[i][2] is None:
            i += 1
        if i >= len(phrases):
            break
        goal = rng.normal(goal_mean_s, goal_std_s) * sample_rate
        start = phrases[i][0]
        end = phrases[i][1]
        text = phrases[i][2]
        i += 1
        while (
            i < len(phrases)
            and phrases[i][2] is not None
            and (end - start) < goal
            and (phrases[i][1] - start) <= max_s * sample_rate
        ):
            end = phrases[i][1]
            text = text + " " + phrases[i][2]
            i += 1
        dur = (end - start) / sample_rate
        if min_s <= dur <= max_s and text.strip():
            out.append((start, end, re.sub(r"\s+", " ", text).strip()))
    return out


def write_dataset(
    segments: Iterable[Tuple[str, np.ndarray, str]],
    out_dir: str | Path,
    sample_rate: int,
    *,
    g2p=None,
    val_fraction: float = 0.03,
    max_phonemes: int = 500,
    seed: int = 0,
) -> dict:
    """Write WAVs + `file|phonemes|0|text` train/val lists in the layout
    the trainer consumes (duration-bucketed lists like the reference's
    train-list-{400,800,1200,1600}.txt, make-segments.py:11-49)."""
    from scipy.io import wavfile

    if g2p is None:
        from ..textfrontend import G2P

        g2p = G2P()
    from ..textfrontend import normalize_text

    out = Path(out_dir)
    (out / "wav24").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    buckets = {400: [], 800: [], 1200: [], 1600: []}
    val: List[str] = []
    stats = {"written": 0, "skipped_phonemes": 0}
    for name, audio, text in segments:
        phonemes = g2p(normalize_text(text))
        if len(phonemes) >= max_phonemes:
            stats["skipped_phonemes"] += 1
            continue
        wavfile.write(
            str(out / "wav24" / name), sample_rate,
            (np.clip(audio, -1, 1) * 32767).astype(np.int16),
        )
        words = " ".join(text.replace("|", " ").split())
        line = f"{name}|{phonemes}|0|{words}"
        dur = len(audio) / sample_rate
        if rng.random() < val_fraction:
            val.append(line)
        elif dur < 5:
            buckets[400].append(line)
        elif dur < 10:
            buckets[800].append(line)
        elif dur < 15:
            buckets[1200].append(line)
        else:
            buckets[1600].append(line)
        stats["written"] += 1
    train_all: List[str] = []
    for limit, lines in sorted(buckets.items()):
        (out / f"train-list-{limit}.txt").write_text(
            "\n".join(lines) + ("\n" if lines else "")
        )
        train_all.extend(lines)
    (out / "train-list.txt").write_text(
        "\n".join(train_all) + ("\n" if train_all else "")
    )
    (out / "val-list.txt").write_text(
        "\n".join(val) + ("\n" if val else "")
    )
    stats["train"] = len(train_all)
    stats["val"] = len(val)
    return stats


# --------------------------------------------------------------------- #
# 5. The whole pipeline
# --------------------------------------------------------------------- #


def parse_phrase_list(path: str | Path) -> List[Tuple[int, int, Optional[str]]]:
    """Read the reference interchange format: `phrase|start|end|text`
    lines (sample offsets) with `skipped` placeholders."""
    out: List[Tuple[int, int, Optional[str]]] = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        fields = line.split("|")
        if fields[0] == "phrase" and len(fields) >= 4:
            out.append((int(fields[1]), int(fields[2]),
                        "|".join(fields[3:]).strip() or None))
        elif fields[0] == "skipped":
            out.append((0, 0, None))
    return out


def prepare_book(
    *,
    audio_files: Sequence[str],
    book_text_file: str,
    out_dir: str,
    sample_rate: int = 24000,
    transcripts: Optional[Sequence[str]] = None,
    seed: int = 0,
    prefix: str = "a",
    val_fraction: float = 0.03,
) -> dict:
    """Chapter audio + book text -> training dataset.

    With per-chapter `transcripts` (phrase|start|end|text from any ASR),
    phrases are fuzzy-matched to the book (reference pipeline).  Without,
    phrases come from silence detection and text from cursor-ordered
    greedy book matching — each phrase takes the next book words whose
    estimated speaking duration best fits the audio span (the
    aligner-scored variant lives in AlignerScorer for curated use).
    ``val_fraction`` is the share drawn into the val list (the JAX
    package's fixed 3%)."""
    from scipy.io import wavfile as _wavfile

    from ..textfrontend import G2P

    g2p = G2P()
    book_text = Path(book_text_file).read_text(encoding="utf-8")
    rng = np.random.default_rng(seed)

    def read_audio(path):
        sr, data = _wavfile.read(path)
        if data.dtype != np.float32:
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        if data.ndim > 1:
            data = data.mean(axis=1)
        if sr != sample_rate:
            # linear resample (dataprep-side; quality-insensitive here)
            idx = np.linspace(0, len(data) - 1, int(len(data) * sample_rate / sr))
            data = np.interp(idx, np.arange(len(data)), data).astype(np.float32)
        return data

    matcher = TranscriptMatcher(book_text, g2p)
    all_segments = []
    for ci, path in enumerate(audio_files):
        audio = read_audio(path)
        if transcripts is not None:
            phrases = parse_phrase_list(transcripts[ci])
            matched = []
            for s, e, text in phrases:
                gt = matcher.match_next(text) if text else None
                matched.append((s, e, gt))
        else:
            spans = detect_phrases(audio, sample_rate)
            matched = []
            words = book_text.split()
            cursor = _BookCursor(words)
            for s, e in spans:
                dur = (e - s) / sample_rate
                matched.append((s, e, cursor.take_seconds(dur)))
        for si, (s, e, text) in enumerate(
            build_segments(matched, sample_rate, rng=rng)
        ):
            name = f"{prefix}-{ci + 1:04d}-{si:05d}.wav"
            all_segments.append((name, audio[s:e], text))
    return write_dataset(
        all_segments, out_dir, sample_rate, g2p=g2p, seed=seed,
        val_fraction=val_fraction,
    )


class _BookCursor:
    """Sequential book reader for the transcript-free path: hands out the
    next run of words whose estimated duration (≈160 wpm + punctuation
    pauses) matches a phrase's audio duration."""

    WORDS_PER_SECOND = 160.0 / 60.0

    def __init__(self, words: List[str]):
        self.words = words
        self.pos = 0

    def take_seconds(self, seconds: float) -> Optional[str]:
        if self.pos >= len(self.words):
            return None
        budget = max(1, int(round(seconds * self.WORDS_PER_SECOND)))
        end = min(len(self.words), self.pos + budget)
        # prefer to end on punctuation near the estimate
        best = end
        for j in range(max(self.pos + 1, end - 4), min(len(self.words), end + 4)):
            if self.words[j - 1][-1:] in ".,;:!?":
                best = j
                break
        taken = self.words[self.pos:best]
        self.pos = best
        return " ".join(taken) if taken else None


# --------------------------------------------------------------------- #
# 6. Book synthesis input (tts/ttab/prepare_book.py counterpart)
# --------------------------------------------------------------------- #


def split_markdown_chapters(text: str) -> List[Tuple[str, str]]:
    """Markdown book -> [(chapter_title, chapter_text)] (reference
    prepare_book.py:17-60: headers start chapters and become titles;
    untitled leading text becomes 'Chapter N').  Headers, emphasis
    markers and reference-style links are stripped from the body."""
    chapters: List[Tuple[str, List[str]]] = []
    title: Optional[str] = None
    body: List[str] = []

    def flush():
        nonlocal title, body
        if title is not None or any(s.strip() for s in body):
            chapters.append((title or "", body))
        title, body = None, []

    for line in text.splitlines():
        m = re.match(r"\s{0,3}(#{1,6})\s+(.*)", line)
        if m:
            flush()
            title = m.group(2).strip()
        else:
            body.append(line)
    flush()

    out: List[Tuple[str, str]] = []
    for i, (t, lines) in enumerate(chapters, 1):
        blob = " ".join(s.strip() for s in lines)
        blob = re.sub(r"[*_`]+", "", blob)              # emphasis/code marks
        blob = re.sub(r"\[([^\]]*)\]\([^)]*\)", r"\1", blob)  # links
        blob = re.sub(r"\s+", " ", blob).strip()
        if not blob:
            continue
        out.append((t or f"Chapter {i}", blob))
    return out

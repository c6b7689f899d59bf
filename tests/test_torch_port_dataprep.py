"""The port's data preparation against the JAX package's: the book
dataset's phrase detection, transcript matching, segments, dataset files
and chapters (identical), and the YIN pitch tracker (within the bounds
below) with its cache through CLI ``pitch``.

The book dataset differs in one field on purpose: the port's list lines
are ``file|phonemes|0|text``, the four fields ``data/dataset.py``, ``pitch``
and ``align`` read; the JAX package's are ``file|phonemes|0``.  Every
other byte (WAVs, phonemes, order, split) is held identical."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from stylish_tts_tpu.config import load_config_json as jax_config
from stylish_tts_tpu.config import \
    load_model_config_json as jax_model_config
from stylish_tts_tpu.dataprep import book as jbook
from stylish_tts_tpu.dataprep import pitch as jpitch
from stylish_tts_tpu_torch.cli import main
from stylish_tts_tpu_torch.config import Config, dump_json
from stylish_tts_tpu_torch.dataprep import book as pbook
from stylish_tts_tpu_torch.dataprep import pitch as ppitch
from stylish_tts_tpu_torch.utils.synthetic import (make_synthetic_dataset,
                                                   tiny_model_config)
from stylish_tts_tpu_torch.utils.tensorfile import read_safetensors
from test_pitch_quality import make_speechlike

SR, HOP = 24000, 300
# YIN, port (torch.fft) against JAX (jnp.fft) in f32 on the CPU: voicing
# agrees on at least this share of the frames, and f0 within this
# relative gap where both are voiced
VOICING_AGREEMENT, F0_REL = 0.99, 5e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tone(seconds, freq=220.0, amp=0.3, seed=None):
    t = np.arange(int(seconds * SR)) / SR
    x = amp * np.sin(2 * np.pi * freq * t)
    if seed is not None:  # a little noise, so the levels are not exact
        x = x + 0.01 * np.random.default_rng(seed).standard_normal(x.shape)
    return x.astype(np.float32)


def silence(seconds):
    return np.zeros(int(seconds * SR), np.float32)


BOOK = (
    'The quick brown fox jumps over the lazy dog. '
    '"Hello there," said the wizard, and the children laughed. '
    'They walked home through the quiet garden before dinner. '
    'Dr. Smith read 3 books in 1999; he paid $25 for the lead record. '
    'Was it the 2nd time? Yes: the 21st, at 5 p.m. precisely!'
)


# --------------------------------------------------------------------------- #
# the book dataset


@pytest.mark.parametrize("case", ["phrases", "long", "quiet", "empty"])
def test_detect_phrases_identical(case):
    rng = np.random.default_rng(3)
    audio = {
        "phrases": np.concatenate([
            silence(0.5), tone(1.2, seed=1), silence(0.6), tone(2.0, 330, 2),
            silence(0.5), tone(0.8, 440, 3), silence(0.4), tone(0.2, 500)]),
        "long": tone(35.0, seed=4) * np.where(
            (np.arange(int(35 * SR)) // SR) % 9 == 4, 0.001, 1.0
        ).astype(np.float32),
        "quiet": (0.02 * rng.standard_normal(3 * SR)).astype(np.float32),
        "empty": np.zeros(100, np.float32),
    }[case]
    got = pbook.detect_phrases(audio, SR)
    assert got == jbook.detect_phrases(audio, SR)
    if case == "phrases":
        assert len(got) == 3


def test_matching_identical():
    transcripts = [
        "the quick brown fox jumps over the lazy dog",
        "hello there said the wizard and the children laughed",
        "completely unrelated zebra nonsense xylophone",
        "they walked home through the quiet garden before dinner",
        "doctor smith read three books",
    ]
    assert vars(pbook.tokenize_book(BOOK)) == vars(jbook.tokenize_book(BOOK))
    ports, jaxs = pbook.TranscriptMatcher(BOOK), jbook.TranscriptMatcher(BOOK)
    got = [ports.match_next(t) for t in transcripts]
    assert got == [jaxs.match_next(t) for t in transcripts]
    assert got[0] == "The quick brown fox jumps over the lazy dog."
    phrases = [(i * SR, (i + 1) * SR, t) for i, t in enumerate(transcripts)]
    phrases.insert(2, (0, 0, None))
    assert pbook.match_transcripts(phrases, BOOK) == \
        jbook.match_transcripts(phrases, BOOK)


def test_build_segments_identical():
    rng = np.random.default_rng(0)
    phrases = [(i * 2 * SR, (i * 2 + 1 + int(rng.integers(0, 3))) * SR,
                None if i % 7 == 3 else f"phrase {i}.") for i in range(40)]
    for seed in range(3):
        got = pbook.build_segments(phrases, SR,
                                   rng=np.random.default_rng(seed))
        assert got
        assert got == jbook.build_segments(phrases, SR,
                                           rng=np.random.default_rng(seed))


def test_parse_phrase_list_identical(tmp_path):
    p = tmp_path / "phrases.txt"
    p.write_text("phrase|0|24000|hello world\nskipped\n"
                 "phrase|24000|48000|more | text\nphrase|1|2|\n")
    assert pbook.parse_phrase_list(p) == jbook.parse_phrase_list(p)


def assert_same_dataset(port_dir: Path, jax_dir: Path) -> int:
    """Every WAV byte-identical, every list the JAX one with the segment's
    text as a fourth field; returns the segments."""
    names = sorted(p.name for p in (jax_dir / "wav24").iterdir())
    assert names and names == sorted(
        p.name for p in (port_dir / "wav24").iterdir())
    for name in names:
        assert (port_dir / "wav24" / name).read_bytes() == \
            (jax_dir / "wav24" / name).read_bytes(), name
    lists = sorted(p.name for p in jax_dir.glob("*.txt"))
    assert lists == sorted(p.name for p in port_dir.glob("*.txt"))
    for name in lists:
        want = (jax_dir / name).read_text().splitlines()
        got = (port_dir / name).read_text().splitlines()
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            fields = g.split("|")
            assert len(fields) == 4 and "|".join(fields[:3]) == w
            assert fields[3] and fields[3] == " ".join(fields[3].split())
    return len(names)


def test_write_dataset_identical(tmp_path):
    segs = [(f"a-0001-{i:05d}.wav", tone(1.5 + 4 * i, seed=i),
             f"hello | world number {i}, the {i}rd") for i in range(5)]
    for pkg, mod in (("port", pbook), ("jax", jbook)):
        stats = mod.write_dataset(segs, tmp_path / pkg, SR, seed=1,
                                  val_fraction=0.3)
        assert stats["written"] == 5
    assert assert_same_dataset(tmp_path / "port", tmp_path / "jax") == 5
    line = (tmp_path / "port" / "train-list.txt").read_text().splitlines()[0]
    assert line.split("|")[3].startswith("hello world number")


@pytest.mark.parametrize("transcribed", [True, False],
                         ids=["transcripts", "transcript_free"])
def test_prepare_book_identical(tmp_path, transcribed):
    chapters = [np.concatenate(sum(
        ([tone(1.8 + 0.7 * i, 180 + 40 * i, seed=10 * c + i), silence(0.6)]
         for i in range(5)), [silence(0.4)])) for c in range(2)]
    wavs = []
    for c, audio in enumerate(chapters):
        wavs.append(str(tmp_path / f"c{c}.wav"))
        wavfile.write(wavs[-1], SR, (audio * 32767).astype(np.int16))
    (tmp_path / "book.txt").write_text(BOOK)
    transcripts = None
    if transcribed:
        words = BOOK.split()
        transcripts = []
        for c, audio in enumerate(chapters):
            path = tmp_path / f"c{c}.phrases.txt"
            spans = jbook.detect_phrases(audio, SR)
            path.write_text("".join(
                f"phrase|{s}|{e}|{' '.join(words[(5 * c + i) * 3:][:3])}\n"
                for i, (s, e) in enumerate(spans)))
            transcripts.append(str(path))
    for pkg, mod in (("port", pbook), ("jax", jbook)):
        mod.prepare_book(audio_files=wavs,
                         book_text_file=str(tmp_path / "book.txt"),
                         out_dir=str(tmp_path / pkg), sample_rate=SR,
                         transcripts=transcripts, seed=2)
    assert assert_same_dataset(tmp_path / "port", tmp_path / "jax") >= 2


def test_split_markdown_chapters_identical():
    md = ("Untitled lead text.\n\n# The Beginning\n\nIt was a *dark* night. "
          "See [the map](http://x).\n\nMore `code` text.\n\n"
          "## Part Two\n\nAnother chapter body.\n\n### Empty\n\n"
          "#### Last\n_Read_ the **lead** record.\n")
    got = pbook.split_markdown_chapters(md)
    assert got == jbook.split_markdown_chapters(md)
    assert [t for t, _ in got] == ["Chapter 1", "The Beginning", "Part Two",
                                   "Last"]


def test_cli_prepare_book(tmp_path, capsys):
    audio = np.concatenate(sum(
        ([tone(1.5 + 0.5 * i, 200 + 30 * i, seed=i), silence(0.6)]
         for i in range(4)), []))
    wavfile.write(str(tmp_path / "c.wav"), SR,
                  (audio * 32767).astype(np.int16))
    (tmp_path / "book.txt").write_text(BOOK)
    main(["prepare-book", "--audio", str(tmp_path / "c.wav"), "--text",
          str(tmp_path / "book.txt"), "--out", str(tmp_path / "ds")])
    assert '"written"' in capsys.readouterr().out
    lines = (tmp_path / "ds" / "train-list.txt").read_text().splitlines()
    assert lines and all(len(line.split("|")) == 4 for line in lines)


# --------------------------------------------------------------------------- #
# YIN


def pitch_inputs():
    """Speech-like harmonics at three F0s, pure noise, silence and a
    vibrato tone, 1.5-3 s each."""
    rng = np.random.default_rng(11)
    waves = [make_speechlike(rng, dur_s=2.0, f0_base=f)[0]
             for f in (95.0, 140.0, 230.0)]
    waves.append((0.1 * rng.standard_normal(int(1.5 * SR))).astype(
        np.float32))
    waves.append(np.zeros(int(1.5 * SR), np.float32))
    t = np.arange(3 * SR) / SR
    f0 = 180.0 * 2.0 ** (0.5 * np.sin(2 * np.pi * 0.7 * t) / 12.0)
    waves.append((0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR)).astype(
        np.float32))
    return waves


@pytest.fixture(scope="module")
def tracks():
    waves = pitch_inputs()
    jax_tracks = jpitch.extract_pitch_batch(waves, SR, HOP)
    port_tracks = ppitch.extract_pitch_batch(waves, SR, HOP, device="cpu")
    return waves, jax_tracks, port_tracks


def test_yin_matches_jax(tracks):
    waves, jax_tracks, port_tracks = tracks
    agree, total, worst, voiced_frames = 0, 0, 0.0, 0
    for wave, want, got in zip(waves, jax_tracks, port_tracks):
        assert got.shape == want.shape == (wave.shape[0] // HOP + 1,)
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        agree += int(np.sum((got > 0) == (want > 0)))
        total += got.shape[0]
        both = (got > 0) & (want > 0)
        voiced_frames += int(both.sum())
        if both.any():
            worst = max(worst, float(np.max(
                np.abs(got[both] - want[both]) / want[both])))
    print(f"YIN port vs JAX: voicing agrees on {agree}/{total} frames, "
          f"worst f0 gap {worst:.2e} over {voiced_frames} voiced frames")
    assert agree >= VOICING_AGREEMENT * total
    assert worst <= F0_REL
    assert voiced_frames > 200  # the harmonics are voiced
    assert not np.any(port_tracks[4])  # silence stays unvoiced


def test_yin_chunks_the_stream(tracks, monkeypatch):
    """Chunks of a few frames give the tracks of one chunk."""
    waves, _, port_tracks = tracks
    monkeypatch.setattr(ppitch, "CHUNK_FRAMES", 97)
    got = ppitch.extract_pitch_batch(waves[:2], SR, HOP, device="cpu")
    for a, b in zip(got, port_tracks[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)


def test_cli_pitch_matches_jax(tmp_path, tracks, capsys):
    """CLI ``pitch`` on a dataset against the JAX package's
    ``calculate_pitch`` on the same files."""
    for name in ("port", "jax"):
        make_synthetic_dataset(tmp_path / name, n_segments=5)
        (tmp_path / name / "pitch.safetensors").unlink()
    cfg = Config()
    cfg.dataset.path = str(tmp_path / "port")
    mc = tiny_model_config()
    (tmp_path / "c.json").write_text(dump_json(cfg))
    (tmp_path / "m.json").write_text(dump_json(mc))
    main(["pitch", "--config", str(tmp_path / "c.json"), "--model-config",
          str(tmp_path / "m.json"), "--device", "cpu"])
    assert "5 segments" in capsys.readouterr().out
    cfg.dataset.path = str(tmp_path / "jax")
    jpitch.calculate_pitch(jax_config(dump_json(cfg)),
                           jax_model_config(dump_json(mc)))
    got = read_safetensors(tmp_path / "port" / "pitch.safetensors")
    want = read_safetensors(tmp_path / "jax" / "pitch.safetensors")
    assert got.keys() == want.keys() and len(got) == 5
    for key in want:
        assert got[key].shape == want[key].shape
        assert np.mean((got[key] > 0) == (want[key] > 0)) >= \
            VOICING_AGREEMENT
        both = (got[key] > 0) & (want[key] > 0)
        assert both.any()
        assert np.max(np.abs(got[key][both] - want[key][both])
                      / want[key][both]) <= F0_REL
    # RMVPE without a weights file: the net is drawn from a seed, as the
    # JAX package falls back to its initialisation; one finite, non-negative
    # track a segment on YIN's frames (tests/test_torch_port_rmvpe.py holds
    # RMVPE against the JAX package)
    main(["pitch", "--config", str(tmp_path / "c.json"), "--method",
          "rmvpe", "--device", "cpu"])
    rmvpe = read_safetensors(tmp_path / "port" / "pitch.safetensors")
    assert rmvpe.keys() == got.keys()
    for key in got:
        assert rmvpe[key].shape == got[key].shape
        assert np.all(np.isfinite(rmvpe[key])) and np.all(rmvpe[key] >= 0)

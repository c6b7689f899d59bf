"""The port's root tools against the JAX package's, on the CPU: raw YIN
(``extract_pitch_batch(refine=False)``), the speech-like generator,
``scripts/pitch_eval.py``'s scoring, ``scripts/train_homographs.py``'s
sentences and training, and ``scripts/g2p_eval.py``'s report.  The JAX
scripts are loaded by path; none is run whole where it would write into
the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stylish_tts_tpu.dataprep import pitch as jpitch
from stylish_tts_tpu_torch.dataprep import pitch as ppitch
from stylish_tts_tpu_torch.scripts import g2p_eval, pitch_eval
from stylish_tts_tpu_torch.scripts import train_homographs
from stylish_tts_tpu_torch.utils.synthetic import make_speechlike
from test_torch_port_dataprep import F0_REL, VOICING_AGREEMENT

ROOT = Path(__file__).resolve().parent.parent
SR, HOP = 24000, 300


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_make_speechlike_equals_the_tests_copy():
    from test_pitch_quality import make_speechlike as tests_copy

    for seed in (0, 42):
        got = make_speechlike(np.random.default_rng(seed), dur_s=1.0,
                              f0_base=120.0)
        want = tests_copy(np.random.default_rng(seed), dur_s=1.0,
                          f0_base=120.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.fixture(scope="module")
def raw_tracks():
    waves, gts = pitch_eval.speechlike_suite(2)
    return (gts, jpitch.extract_pitch_batch(waves, SR, HOP, refine=False),
            ppitch.extract_pitch_batch(waves, SR, HOP, refine=False,
                                       device="cpu"))


def test_raw_yin_matches_jax(raw_tracks):
    """The unrefined track at the refined track's bounds
    (``test_torch_port_dataprep.py``)."""
    _, want_tracks, got_tracks = raw_tracks
    agree = total = voiced = 0
    worst = 0.0
    for got, want in zip(got_tracks, want_tracks):
        assert got.shape == want.shape and got.dtype == np.float32
        agree += int(np.sum((got > 0) == (want > 0)))
        total += got.shape[0]
        both = (got > 0) & (want > 0)
        voiced += int(both.sum())
        worst = max(worst, float(np.max(np.abs(got[both] - want[both])
                                        / want[both])))
    assert agree >= VOICING_AGREEMENT * total and worst <= F0_REL
    assert voiced > 100


def test_raw_and_refined_tracks_differ(raw_tracks):
    """``refine`` reaches the tracks: the refined one moves voiced frames
    and keeps the voicing."""
    _, raw, _ = raw_tracks
    waves, _ = pitch_eval.speechlike_suite(2)
    refined = ppitch.extract_pitch_batch(waves, SR, HOP, device="cpu")
    for r, f in zip(raw, refined):
        np.testing.assert_array_equal(r > 0, f > 0)
        assert not np.array_equal(r, f)


def test_pitch_eval_score_matches_jax(raw_tracks):
    gts, jax_raw, port_raw = raw_tracks
    jax_eval = _jax_script("pitch_eval")
    for tracks in (jax_raw, port_raw):
        assert pitch_eval.score(tracks, gts) == jax_eval.score(tracks, gts)


def test_pitch_eval_entry_point(capsys):
    assert pitch_eval.main(["--cpu", "--utts", "1"]) == 0
    report = json.loads(capsys.readouterr().out)
    for name in ("yin_raw", "yin_stonemask_refined"):
        assert set(report[name]) == {"cents_mae", "cents_p95",
                                     "gross_error_rate", "vuv_f1"}


def test_pitch_eval_evaluate_returns_the_tracks_it_scored():
    """``evaluate`` gives the tracks beside the report (the smoke holds
    the card's tracks against the CPU's): each report entry is ``score``
    of its track, and the tracks are ``extract_pitch_batch``'s."""
    report, tracks = pitch_eval.evaluate(1, "cpu")
    waves, gts = pitch_eval.speechlike_suite(1)
    for name, refine in (("yin_raw", False), ("yin_stonemask_refined", True)):
        assert report[name] == pitch_eval.score(tracks[name], gts)
        want = ppitch.extract_pitch_batch(waves, SR, HOP, refine=refine,
                                          device="cpu")
        for got, w in zip(tracks[name], want, strict=True):
            np.testing.assert_array_equal(got, w)


def test_homograph_sentences_and_training_match_jax(tmp_path):
    """The templated sentences, the split and 2 epochs of training: the
    port's file holds the weights the JAX script's steps give."""
    jax_th = _jax_script("train_homographs")
    rows = train_homographs.build_dataset()
    assert rows == jax_th.build_dataset()
    report = train_homographs.train(epochs=2, out=tmp_path / "lr.npz")

    order = np.random.default_rng(1).permutation(len(rows))
    tr = order[:int(0.9 * len(rows))]
    index = jax_th.pack_indices([jax_th.feature_indices(s, l, r)
                                 for s, l, r, _ in rows])
    y = np.array([lab for *_, lab in rows], np.float32)
    rs = np.array([jax_th.rule_score(s, l, r) for s, l, r, _ in rows],
                  np.float32)
    clf = jax_th.train_logreg(index[tr], y[tr], rs[tr], epochs=2)
    got = np.load(tmp_path / "lr.npz")
    np.testing.assert_array_equal(got["w"], clf.w)
    assert float(got["b"]) == np.float32(clf.b)
    assert float(got["alpha"]) == np.float32(clf.alpha)
    assert report["train_sentences"] == len(tr)
    assert report["weights"] == str(tmp_path / "lr.npz")


def test_homograph_weights_compare(tmp_path):
    """``compare_weights`` sees equal files and names a difference."""
    committed = train_homographs._WEIGHTS_PATH
    assert committed.parent.parent.name == "textfrontend"
    assert train_homographs.compare_weights(committed) == {
        "equal": True, "max_abs_diff": {"w": 0.0, "b": 0.0, "alpha": 0.0}}
    data = dict(np.load(committed))
    data["b"] = data["b"] + np.float32(0.5)
    np.savez(tmp_path / "other.npz", **data)
    out = train_homographs.compare_weights(tmp_path / "other.npz")
    assert not out["equal"] and out["max_abs_diff"]["b"] == 0.5


def test_g2p_eval_matches_jax_on_a_slice_of_each_file(tmp_path,
                                                      monkeypatch):
    """The report on the first lines of each of the three files."""
    data = ROOT / "tests" / "data"
    for name, lines in ((g2p_eval.GOLDEN, 40), (g2p_eval.CMU_GOLDEN, 150),
                        (g2p_eval.EXTERNAL_HOMOGRAPHS, 40)):
        text = (data / name).read_text().splitlines()[:lines]
        (tmp_path / name).write_text("\n".join(text) + "\n")
    jax_eval = _jax_script("g2p_eval")
    monkeypatch.setattr(jax_eval, "GOLDEN", tmp_path / g2p_eval.GOLDEN)
    monkeypatch.setattr(jax_eval, "CMU_GOLDEN",
                        tmp_path / g2p_eval.CMU_GOLDEN)
    monkeypatch.setattr(jax_eval, "EXTERNAL_HOMOGRAPHS",
                        tmp_path / g2p_eval.EXTERNAL_HOMOGRAPHS)
    monkeypatch.setattr("sys.argv", ["g2p_eval", "--out",
                                     str(tmp_path / "jax.json")])
    assert jax_eval.main() == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    assert g2p_eval.evaluate(tmp_path) == want
    assert want["external_homographs"]["cases"] > 10


def test_g2p_regen_golden_needs_espeak(tmp_path, monkeypatch):
    monkeypatch.setattr(g2p_eval.shutil, "which", lambda name: None)
    (tmp_path / g2p_eval.GOLDEN).write_text("cat\tkˈæt\n")
    with pytest.raises(SystemExit, match="espeak"):
        g2p_eval.main(["--regen-golden", "--data", str(tmp_path)])

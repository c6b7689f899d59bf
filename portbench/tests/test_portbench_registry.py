"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and new entries of BENCHMARK.json alone: the harness finds
them by name, and no file that is there changes."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import registry, synth_cell, traffic
from portbench.tests import rehearsal


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ROOT = registry.ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.benchmark(ROOT)
    before = _digests(tmp_path)
    base = tmp_path / "portbench"
    config = json.loads((base / "configs" / "freegan.json").read_text())
    (base / "configs" / "dummy.json").write_text(json.dumps(config))
    mix = dict(json.loads((base / "traffic" / "synth_b8_closed.json")
                          .read_text()), batch=4)
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (base / "limits" / "dummy.dummy_mix.json").write_text(
        json.dumps({"pcm_gap": 0.5}))
    (base / "metrics" / "dummy_ms.synth.py").write_text(
        "def read(seg, run):\n    return 42.0\n")
    bench["configs"].append({"name": "dummy", "source": "https://example.org",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "synth_audio_s_per_s":
            m["workloads"].append("dummy.dummy_mix")
    bench["per_layer"].append({"name": "dummy_ms.synth", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device",
                               "moves": "synth_audio_s_per_s",
                               "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("dummy.dummy_mix", tmp_path)
    assert cell.config == config and cell.traffic["batch"] == 4
    assert cell.limits == {"pcm_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == [
        "synth_audio_s_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms.synth"]
    assert registry.readers(cell, tmp_path)["dummy_ms.synth"](None, {}) == 42
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_finds_its_files():
    bench = registry.benchmark(ROOT)
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert cell.limits and registry.kind(cell).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for name, read in registry.readers(cell).items():
            assert callable(read), name


TOY_KIND = """
def run(cell, seed, seconds, trace, device, t_start):
    return {"numbers": {"toy_gap": (0.0, "toy")}, "segment": None,
            "host": {}, "attempted": 1, "failed": 0, "peak_bytes": 0,
            "readings": {}, "e2e": {"toy_per_s": float(cell.traffic["n"]),
                                    "setup_s": 1.0}}
"""

TOY_RUN = """
import sys
from unittest import mock
from portbench import card, registry, run
cell = registry.cell("dummy.toy_mix")
out = registry.kind(cell).run(cell, 1, 1.0, False, None, 0.0)
with mock.patch.object(card, "describe", lambda chips, peak: {}):
    sys.exit(run.finish(cell, out, False))
"""


def test_a_new_kind_of_mix_is_new_files(tmp_path):
    """A mix of a kind the harness has no module for yet is driven by a new
    ``<kind>_cell.py``, with its cell, mix, limits and end-to-end metric,
    and no file that is there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    base = tmp_path / "portbench"
    (base / "toy_cell.py").write_text(TOY_KIND)
    (base / "traffic" / "toy_mix.json").write_text(
        json.dumps({"kind": "toy", "n": 7}))
    (base / "limits" / "dummy.toy_mix.json").write_text(
        json.dumps({"toy_gap": 0.5}))
    bench = registry.benchmark(ROOT)
    bench["workloads"].append({"name": "dummy.toy_mix", "config": "freegan",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "toy_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.toy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["toy_per_s"]["value"] == 7.0
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_kind_entry_order_or_stage_is_refused():
    cell = registry.cell("freegan.synth_b8_closed")
    cell.traffic = dict(cell.traffic, kind="nonesuch")
    with pytest.raises(ValueError, match="nonesuch_cell.py"):
        registry.kind(cell)
    mix = registry.cell("freegan.synth_b8_closed").traffic
    with pytest.raises(ValueError, match="no synthesis entry"):
        synth_cell.Client(None, dict(mix, entry="synthesize_longform"), 8)
    with pytest.raises(ValueError, match="batch 1"):
        synth_cell.Client(None, dict(mix, entry="synthesize"), 8)
    with pytest.raises(ValueError, match="no order"):
        traffic.synth_cycle(None, dict(mix, order="shortest_first"), 1)
    from portbench import train_cell
    train = registry.cell("freegan.acoustic_b15")
    train.traffic = dict(train.traffic, stage="textual")
    with pytest.raises(ValueError, match="'textual'"):
        train_cell.setup(train, 1, torch.device("cpu"))


def test_grouped_lengths_send_the_same_sizes():
    from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config

    mc = tiny_model_config()
    mix = dict(registry.cell("freegan.synth_b32_pipelined").traffic,
               batch=4, cycle=5, phonemes=[10, 49])
    drawn = traffic.synth_cycle(mc, mix, 2**31 + 5)
    grouped = traffic.synth_cycle(mc, dict(mix, order="by_length"),
                                  2**31 + 5)
    sizes = [sorted(len(t) for t in b) for b in grouped]
    assert sorted(n for b in sizes for n in b) == sorted(
        len(t) for b in drawn for t in b)
    # each batch holds four neighbouring lengths of the 20 sent
    assert all(b[-1] - b[0] <= 7 for b in sizes)


@pytest.mark.parametrize("mix", [
    {"entry": "synthesize", "batch": 1, "in_flight": 1,
     "phonemes": [60, 320]},
    {"order": "by_length"}], ids=["single_long", "b32_sorted"])
def test_later_synthesis_cells_are_data_alone(tmp_path, mix):
    """Two cells PERF.md keeps for later, ``freegan.synth_single_long`` and
    ``freegan.synth_b32_sorted``, are a mix file, a limits file and
    entries: a tiny run of each is correct."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "portbench"
    mix = dict(json.loads((base / "traffic" / "synth_b32_pipelined.json")
                          .read_text()), **mix)
    (base / "traffic" / "later.json").write_text(json.dumps(mix))
    (base / "limits" / "freegan.later.json").write_text(
        (base / "limits" / "freegan.synth_b32_pipelined.json").read_text())
    bench = registry.benchmark(ROOT)
    bench["workloads"].append({"name": "freegan.later", "config": "freegan",
                               "traffic": "later", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, out = rehearsal.run("freegan.later",
                              cell=rehearsal.tiny_cell("freegan.later",
                                                       tmp_path))
    assert out["numbers"]["pcm_gap"][0] <= cell.limits["pcm_gap"]
    assert out["attempted"] > 0 and out["failed"] == 0

"""The run's look for a card and for JAX: no card means no result, and the
import check compares top-level module names whole."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import card, registry

ROOT = registry.ROOT


@pytest.mark.parametrize("name", [
    "stylish_tts_tpu_torch", "stylish_tts_tpu_torch.ops.stft",
    "jaxtyping", "flaxen", "stylish_tts_tpu_torchvision", "portbench.run"])
def test_allowed_top_level_names(name):
    assert card.forbidden_modules([name]) == []


@pytest.mark.parametrize("name", [
    "stylish_tts_tpu", "stylish_tts_tpu.x", "jax", "jax.numpy", "jaxlib",
    "jaxlib.xla_client", "flax", "flax.linen"])
def test_forbidden_top_level_names(name):
    assert card.forbidden_modules([name]) == [name]


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_without_a_result():
    out = _run("import sys, torch; torch.cuda.is_available = lambda: False;"
               "from portbench import run; sys.exit(run.main(["
               "'--workload', 'freegan.acoustic_b15', '--seed', "
               "'4294967311', '--seconds', '1', '--trace', '0']))")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_harness_and_reference_load_neither_jax_nor_the_program():
    out = _run(
        "import sys, json\n"
        "import portbench.run, portbench.train_cell, portbench.synth_cell\n"
        "import portbench.control, portbench.reference.build\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "stylish_tts_tpu",
                      "stylish_tts_tpu_torch"}


def test_the_program_loads_no_jax():
    out = _run(
        "import sys, json\n"
        "import stylish_tts_tpu_torch.train.stages\n"
        "import stylish_tts_tpu_torch.export.infer\n"
        "import portbench.card as c\n"
        "print(json.dumps(c.forbidden_modules()))")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


FAKE_RUN = """
import sys
from unittest import mock
from portbench import card, registry, run
from portbench.trace import Segment

cell = registry.cell("freegan.synth_b8_closed")
seg = Segment(units=1, window_s=1.0, device_ops=[("k", 0.0, 0.5)],
              host_ops=[], calls={})
out = {"numbers": {"pcm_gap": (0.01, "utterance 0")}, "segment": seg,
       "host": {"dispatch_s": [0.1]}, "attempted": 8, "failed": 0,
       "peak_bytes": 0, "readings": {}, "e2e": {}}
with mock.patch.object(card, "describe", lambda chips, peak: {}):
    sys.exit(run.finish(cell, out, True))
"""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The import check runs after the per-layer readers, last before the
    result: a reader that imports a module named ``jax`` (a stub here)
    leaves the run with no result line and a non-zero exit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "portbench" / "metrics" / "probe_ms.synth.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(seg, host):\n"
        "    return 1.0\n")
    bench = registry.benchmark(ROOT)
    bench["per_layer"].append({
        "name": "probe_ms.synth", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "device",
        "moves": "synth_audio_s_per_s",
        "workloads": ["freegan.synth_b8_closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def fake_run():
        return subprocess.run(
            [sys.executable, "-c", FAKE_RUN], cwd=tmp_path,
            capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})

    out = fake_run()
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr
    # the same run without the reader prints its result
    (tmp_path / "portbench" / "metrics" / "probe_ms.synth.py").write_text(
        "def read(seg, host):\n    return 1.0\n")
    out = fake_run()
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["probe_ms.synth"]["value"] == 1.0
    assert list(line)[-1] == "compared"

"""The port and its smoke script import nothing of JAX or the JAX package,
nothing of ``tests/`` (the port keeps its own copies of what it needs
there, such as ``utils/synthetic.py:make_speechlike``), and neither
``transformers`` nor ``safetensors``, which the card's machine lacks
(files go through ``utils/tensorfile.py``).

The whole top-level name is compared, not a prefix: ``stylish_tts_tpu_torch``
starts with ``stylish_tts_tpu``.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# the test modules are importable by their bare names where ``tests/`` is
# on the path, as under pytest
TEST_MODULES = {"tests"} | {p.stem for p in (ROOT / "tests").glob("*.py")}
FORBIDDEN = {"jax", "flax", "optax", "stylish_tts_tpu", "transformers",
             "safetensors"} | TEST_MODULES
SOURCES = sorted((ROOT / "stylish_tts_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports_nothing_of_jax(path):
    bad = imported_top_names(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_check_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom stylish_tts_tpu_torch import cli\n"
                     "def f():\n    from stylish_tts_tpu.ops import stft\n"
                     "import jax.numpy as jnp\n"
                     "from test_pitch_quality import make_speechlike\n")
    assert imported_top_names(probe) == {
        "os", "stylish_tts_tpu_torch", "stylish_tts_tpu", "jax",
        "test_pitch_quality"}
    assert imported_top_names(probe) & FORBIDDEN == {
        "stylish_tts_tpu", "jax", "test_pitch_quality"}


def test_the_check_covers_every_subpackage():
    packages = {p.parent for p in (ROOT / "stylish_tts_tpu_torch")
                .rglob("__init__.py")}
    covered = {p.parent for p in SOURCES}
    assert packages <= covered
    names = {p.relative_to(ROOT / "stylish_tts_tpu_torch").parts[0]
             for p in SOURCES if p.parent != ROOT}
    assert {"textfrontend", "dataprep", "models", "ops", "train",
            "scripts"} <= names
    scripts = {p.name for p in SOURCES if p.parent.name == "scripts"}
    assert {"pitch_eval.py", "train_homographs.py", "g2p_eval.py"} <= scripts
    assert {"test_pitch_quality", "conftest", "tests"} <= FORBIDDEN

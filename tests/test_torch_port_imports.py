"""The port and its smoke script import nothing of JAX or the JAX package.

The whole top-level name is compared, not a prefix: ``stylish_tts_tpu_torch``
starts with ``stylish_tts_tpu``.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "optax", "stylish_tts_tpu"}
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
                     "import jax.numpy as jnp\n")
    assert imported_top_names(probe) == {
        "os", "stylish_tts_tpu_torch", "stylish_tts_tpu", "jax"}

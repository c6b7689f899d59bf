"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, its limits in ``limits/<workload>.json``,
each per-layer metric's reader in ``metrics/<metric>.py``, and the code
that drives a mix of kind ``K`` (the mix's ``kind``) in ``K_cell.py``.  A
later cell, configuration, mix, kind of mix or metric is new files and new
entries, never an edit of a file that is here."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
KIND = re.compile(r"^[a-z][a-z0-9_]{0,31}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the mix's parameters
    limits: dict  # name -> limit of each number compared
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    base = root / "portbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((base / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell_: Cell, root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], root) for m in cell_.per_layer}


def kind(cell_: Cell):
    """The module that drives the cell's mix: ``portbench/<kind>_cell.py``,
    whose ``run(cell, seed, seconds, trace, device, t_start)`` returns the
    run's output."""
    name = cell_.traffic.get("kind", "")
    if not KIND.match(name):
        raise ValueError(f"{cell_.name}: the mix's kind {name!r} is not a "
                         f"name of a kind")
    try:
        return importlib.import_module(f"portbench.{name}_cell")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.{name}_cell":
            raise
        raise ValueError(f"{cell_.name}: no portbench/{name}_cell.py drives "
                         f"mixes of kind {name!r}") from None

"""Everything of a cell, found by name from ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is its ``workloads`` entry, the configuration
file that its config entry names, ``traffic/<traffic>.json``, the modules
that these two name (``calls/<call>.py``, ``inputs/<distribution>.py``,
``reference/<reference>.py``), ``limits/<cell>.json`` (the limit of each
number ``correct`` compares) and one reader ``metrics/<metric>.py`` for
each metric that applies to it. A later cell needs files and entries
only: nothing here names a cell, a call, an input or a metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    call: ModuleType
    inputs: ModuleType
    reference: ModuleType
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = benchmark(root)
    w = _one(bench["workloads"], name, "workload")
    c = _one(bench["configs"], w["config"], "config")
    base = root / HERE.name
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    config = json.loads((root / c["file"]).read_text())
    return Cell(
        name=name,
        workload=w,
        config=config,
        traffic=traffic,
        call=load("calls", traffic["call"], root),
        inputs=load("inputs", config["input"]["distribution"], root),
        reference=load("reference", config["reference"], root),
        limits=json.loads((base / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def load(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<folder>/<name>.py`` of the benchmark: a call
    (``calls/__init__.py`` lists what it holds), an input distribution, a
    plain reference, or a metric's reader, whose ``read(record)`` gives the
    metric's value or None where the run holds nothing for it to read."""
    path = Path(root) / HERE.name / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"qrbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod

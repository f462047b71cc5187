"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with cells on tiny configurations that the program's
plain CPU versions factor in well under a second."""

import json
import shutil
from pathlib import Path

import pytest

from qrbench import spec

TINY = {
    "square-tiny": {"shape": [256, 256],
                    "qrconfig": {"nb": 64, "ib": 32, "chunk": 2, "precision": "highest"}},
    "tall-tiny": {"shape": [4096, 64], "qrconfig": {"nb": 64, "ib": 32}},
}
CELLS = {"square-tiny.qr": "square-8192.qr",
         "tall-tiny.tree-r": "tall-1048576x512.tree-r",
         "tall-tiny.cholqr2-factor": "tall-1048576x512.cholqr2-factor"}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda_only: needs a CUDA device (tileqr_torch kernels)")


def make_checkout(dst: Path) -> Path:
    """A checkout holding BENCHMARK.json and qrbench/ only, with the tiny
    cells added the way a later change adds one: files and entries."""
    shutil.copytree(spec.HERE, dst / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    for name, over in TINY.items():
        big = "square-8192" if name.startswith("square") else "tall-1048576x512"
        cfg = json.loads((spec.ROOT / f"qrbench/configs/{big}.json").read_text())
        cfg.update(over, name=name)
        (dst / f"qrbench/configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": ["shape"],
                                 "file": f"qrbench/configs/{name}.json", "why": "test"})
    for cell, like in CELLS.items():
        shutil.copy(dst / f"qrbench/limits/{like}.json", dst / f"qrbench/limits/{cell}.json")
        config, traffic = cell.split(".", 1)
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    from qrbench import run

    monkeypatch.setattr(run, "TRACE_SECONDS", 0.05)  # short traced windows on the CPU
    monkeypatch.setattr(run, "TRACE_CALLS", 2)
    return make_checkout(tmp_path)

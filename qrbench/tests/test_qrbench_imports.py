"""What the benchmark runs imports neither JAX nor the JAX package, and the
reference imports nothing of the program; top-level names compared whole."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from qrbench import spec
from qrbench.run import FORBIDDEN, forbidden_loaded

SOURCES = sorted(p for p in spec.HERE.rglob("*.py"))
YARDSTICK = ("reference", "calls", "judge.py", "lawn41.py", "trace.py", "spec.py")


def _tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for p in SOURCES:
        bad = set(_tops(p)) & set(FORBIDDEN)
        assert not bad, (p, bad)


def test_the_yardstick_imports_nothing_of_the_program():
    for p in SOURCES:
        rel = p.relative_to(spec.HERE).as_posix()
        if rel.startswith(YARDSTICK):
            assert "tileqr_torch" not in set(_tops(p)), p


def test_names_are_compared_whole():
    assert forbidden_loaded(["tileqr_torch", "tileqr_torch.api", "jaxtyping", "flax_x"]) == []
    assert forbidden_loaded(["tileqr.api", "jax._src.core", "jaxlib"]) == ["jax", "jaxlib",
                                                                         "tileqr"]


def test_a_cpu_run_loads_no_forbidden_module(checkout):
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from qrbench.run import run_cell, forbidden_loaded\n"
        f"root = Path({str(checkout)!r})\n"
        "res = run_cell('tall-tiny.tree-r', 1, 0.2, False, device='cpu', root=root)\n"
        "print(json.dumps({'correct': res['correct'], 'bad': forbidden_loaded()}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=checkout, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"correct": True, "bad": []}


def test_without_a_card_or_the_program_no_result(checkout):
    """No CUDA card here: exit 2 and no result line. A checkout holding only
    BENCHMARK.json and qrbench/ fails too."""
    for env_path in (str(spec.ROOT), ""):
        env = dict(os.environ, PYTHONPATH=env_path)
        proc = subprocess.run([sys.executable, "-m", "qrbench.run", "--workload",
                               "square-tiny.qr", "--seed", "1", "--seconds", "1",
                               "--trace", "0"], capture_output=True, text=True, env=env,
                              cwd=checkout, timeout=300)
        assert proc.returncode != 0
        assert "correct" not in proc.stdout

"""The harness end to end on tiny cells, on the CPU (the program's plain
versions), and a cell, a metric and a configuration added by files alone."""

import io
import json

import pytest

from qrbench import spec
from qrbench.run import run_cell
from qrbench.tests.conftest import CELLS

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _run(checkout, cell, trace=False, seconds=0.6, seed=2**31 + 5):
    out, err = io.StringIO(), io.StringIO()
    res = run_cell(cell, seed, seconds, trace, device="cpu", root=checkout, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_correct_with_the_five_keys(checkout, cell):
    res, out, err = _run(checkout, cell)
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    json.dumps(res)  # one JSON object
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    want = {m["name"] for m in spec.cell(cell, checkout).end_to_end}
    assert set(res["metrics"]) == want == {"tflops", "call_p90_ms", "backward_error", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["metrics"]["tflops"]["unit"] == "TFLOP/s"
    limits = spec.cell(cell, checkout).limits
    assert set(res["checks"]) == set(limits)
    for key, ch in res["checks"].items():
        assert ch["limit"] == limits[key] and 0 < ch["value"] <= ch["limit"]
    # the checks are the last lines of standard error, each with its limit
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split()[1] for line in tail] == list(limits)
    assert all(" limit " in line for line in tail)


def test_traced_run_reports_the_per_layer_metrics_it_can_read(checkout):
    res, out, _ = _run(checkout, "tall-tiny.tree-r", trace=True)
    assert res["correct"] is True
    # on the CPU there is no device trace: only the host span's metric
    assert set(res["metrics"]) == {"enqueue_ms"}
    assert "trace:" in out


def test_a_cell_metric_config_and_input_added_by_files_alone(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cfg = json.loads((checkout / "qrbench/configs/tall-tiny.json").read_text())
    # a distribution of its own: well conditioned, G + 4·√n·I on the top rows
    cfg.update(name="tall-wide", shape=[2048, 32],
               input={"distribution": "shifted", "shift": 4.0})
    (checkout / "qrbench/configs/tall-wide.json").write_text(json.dumps(cfg))
    (checkout / "qrbench/inputs/shifted.py").write_text(
        "import torch\n\n"
        "def make(shape, dtype, generator, device, shift):\n"
        "    a = torch.randn(shape, generator=generator, dtype=dtype, device=device)\n"
        "    a.diagonal().add_(shift * shape[-1] ** 0.5)\n"
        "    return a\n")
    (checkout / "qrbench/limits/tall-wide.tree-r.json").write_text(
        (checkout / "qrbench/limits/tall-tiny.tree-r.json").read_text())
    (checkout / "qrbench/metrics/calls_done.py").write_text(
        "def read(rec):\n    return float(sum(1 for c in rec.calls if c[3]))\n")
    bench["configs"].append({"name": "tall-wide", "source": "test", "reduced": [],
                             "file": "qrbench/configs/tall-wide.json", "why": "test"})
    bench["workloads"].append({"name": "tall-wide.tree-r", "config": "tall-wide",
                               "traffic": "tree-r", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "count", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tall-wide.tree-r"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _, _ = _run(checkout, "tall-wide.tree-r")
    assert res["correct"] is True
    assert res["metrics"]["calls_done"]["value"] == res["attempted"]
    assert "calls_done" not in _run(checkout, "tall-tiny.tree-r")[0]["metrics"]


def _add_cell(checkout, config, traffic, limits_like):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = f"{config}.{traffic}"
    (checkout / f"qrbench/limits/{cell}.json").write_text(
        (checkout / f"qrbench/limits/{limits_like}.json").read_text())
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                               "chips": 1, "why": "test"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def test_a_new_traffic_added_as_data_alone(checkout):
    """The tall R by CholeskyQR2 rather than the tree: an existing call with
    other arguments, a data file and limits."""
    (checkout / "qrbench/traffic/cholqr2-r.json").write_text(json.dumps(
        {"call": "tsqr_r", "args": {"strategy": "cholqr2"}}))
    cell = _add_cell(checkout, "tall-tiny", "cholqr2-r", "tall-tiny.tree-r")
    res, _, _ = _run(checkout, cell)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"r_gap", "gram_resid"}


def test_a_new_call_added_by_a_module_alone(checkout):
    """qr(a, mode="r"), an entry's mode that no cell drives: a module of
    calls/, a traffic file and limits; nothing of the harness edited."""
    (checkout / "qrbench/calls/qr_r.py").write_text(
        (checkout / "qrbench/calls/tsqr_r.py").read_text().replace(
            'tq.tsqr(a, "r", cfg, **args)', 'tq.qr(a, mode="r", config=cfg, **args)'))
    (checkout / "qrbench/traffic/r.json").write_text(json.dumps({"call": "qr_r"}))
    cell = _add_cell(checkout, "square-tiny", "r", "tall-1048576x512.tree-r")
    res, _, _ = _run(checkout, cell)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"r_gap", "gram_resid"}
    assert res["metrics"]["backward_error"]["value"] == res["checks"]["gram_resid"]["value"]


def test_the_same_seed_gives_the_same_inputs():
    import torch

    from qrbench.workload import make_member

    c = spec.cell("tall-1048576x512.tree-r")
    c = c._replace(config=dict(c.config, shape=[64, 16]))
    big = 2**31 + 123456789
    a, b = make_member(c, big, 0, "cpu"), make_member(c, big, 0, "cpu")
    assert a.shape == (64, 16) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, make_member(c, big, 1, "cpu"))
    assert not torch.equal(a, make_member(c, big + 1, 0, "cpu"))

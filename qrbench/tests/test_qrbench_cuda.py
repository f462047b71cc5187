"""Each cell once, briefly, on the card: ``correct`` true, the result's
keys, and with ``--trace 1`` every per-layer metric and a breakdown.

    python -m pytest qrbench/tests/test_qrbench_cuda.py -q

The card is looked for inside the test: without one they skip."""

import io

import pytest

from qrbench import spec
from qrbench.run import run_cell

pytestmark = pytest.mark.cuda_only
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    _card()
    res = run_cell(cell, 2**31 + 99, 3.0, bool(trace), out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True, res["checks"]
    c = spec.cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["kernel_roofline_pct"]["value"] <= 100
        assert len(res["breakdown"]["device_ops"]) <= 10

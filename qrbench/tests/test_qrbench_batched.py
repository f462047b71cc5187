"""The ``batched-4096x128`` cells' files on the CPU: tiny batched cells
(12 × 40 × 36, padded to 40 columns on the hh route) added to a checkout
the way a later change adds one, run whole (``run_cell``) under the real
cells' limits; the TF32 control, the IEEE fp32 reference and one altered
member through the timed path; the batched reference against
``householder.py`` member by member; the call's LAWN 41 counts."""

import io
import json

import pytest
import torch

import tileqr_torch
from qrbench import lawn41, spec
from qrbench.reference import householder, householder_batched
from qrbench.run import run_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")
TRAFFICS = ["hh", "cholqr2"]


def _add_batched(checkout):
    """The tiny configuration and its two cells, with the real cells' limits."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cfg = json.loads((checkout / "qrbench/configs/batched-4096x128.json").read_text())
    cfg.update(name="batched-tiny", shape=[12, 40, 36])
    (checkout / "qrbench/configs/batched-tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "batched-tiny", "source": "test", "reduced": ["shape"],
                             "file": "qrbench/configs/batched-tiny.json", "why": "test"})
    for traffic in TRAFFICS:
        (checkout / f"qrbench/limits/batched-tiny.{traffic}.json").write_text(
            (checkout / f"qrbench/limits/batched-4096x128.{traffic}.json").read_text())
        bench["workloads"].append({"name": f"batched-tiny.{traffic}", "config": "batched-tiny",
                                   "traffic": traffic, "chips": 1, "why": "test"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))


def _run(checkout, cell, seed=2**31 + 17):
    err = io.StringIO()
    res = run_cell(cell, seed, 0.3, False, device="cpu", root=checkout, out=io.StringIO(),
                   err=err)
    return res, err.getvalue()


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_tiny_batched_cell_runs_correct_with_the_five_keys(checkout, traffic):
    _add_batched(checkout)
    cell = f"batched-tiny.{traffic}"
    res, err = _run(checkout, cell)
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"tflops", "call_p90_ms", "backward_error", "setup_s"}
    assert set(res["checks"]) == {"r_gap", "resid", "orth"}
    assert res["metrics"]["backward_error"]["value"] == res["checks"]["resid"]["value"]
    assert "FAILED" not in err


@pytest.mark.parametrize("traffic", TRAFFICS)
@pytest.mark.parametrize("precision,correct", [("tf32", False), ("ieee", True)])
def test_the_batched_reference_in_the_programs_place(checkout, monkeypatch, traffic,
                                                     precision, correct):
    _add_batched(checkout)
    c = spec.cell(f"batched-tiny.{traffic}", checkout)
    monkeypatch.setattr(tileqr_torch, "qr_batched",
                        lambda a, *args, **kw: c.call.reference(c.reference, a, precision))
    res, err = _run(checkout, c.name)
    assert res["correct"] is correct, res["checks"]
    assert res["failed"] == 0
    assert ("FAILED" in err) is not correct


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_one_altered_member_makes_the_run_not_correct(checkout, monkeypatch, traffic):
    """Member 5's R moved by 1e-3 of its largest entry, the 11 others left
    as they are: the worst member decides."""
    _add_batched(checkout)
    orig = tileqr_torch.qr_batched

    def altered(*args, **kw):
        q, r = orig(*args, **kw)
        r = r.clone()
        r[5, 0, -1] += 1e-3 * r[5].abs().max()
        return q, r
    monkeypatch.setattr(tileqr_torch, "qr_batched", altered)
    res, err = _run(checkout, f"batched-tiny.{traffic}")
    assert res["correct"] is False and res["failed"] == 0
    assert res["checks"]["r_gap"]["value"] > res["checks"]["r_gap"]["limit"]
    assert "FAILED" in err


@pytest.mark.parametrize("shape", [(5, 40, 36), (3, 70, 70), (4, 33, 9)])
def test_the_batched_reference_is_householder_member_by_member(shape):
    a = torch.randn(*shape, dtype=torch.float64, generator=torch.Generator().manual_seed(9))
    f = householder_batched.qr(a, keep=True)
    q = householder_batched.form_q(f)
    for i in range(shape[0]):
        one = householder.qr(a[i], keep=True)
        scale = one.r.abs().max()
        assert (f.r[i] - one.r).abs().max() <= 1e-12 * scale
        assert (q[i] - householder.form_q(one)).abs().max() <= 1e-12


def test_the_call_counts_lawn41_by_hand():
    call = spec.load("calls", "qr_batched")
    b, m, n = 4096, 128, 128
    # geqrf(n, n) = 2n³ − 2n³/3 = 4n³/3; orgqr(n, n, n) = 4n³ − 4n³ + 4n³/3 = 4n³/3
    assert call.flops((b, m, n)) == pytest.approx(b * 8 * n**3 / 3)
    assert call.flops((b, m, n)) == pytest.approx(2.2906e10, rel=1e-4)
    m = 200  # tall members: 2mn² − 2n³/3, and 4mn² − 2(m + n)n² + 4n³/3
    assert call.flops((b, m, n)) == pytest.approx(
        b * (lawn41.geqrf(m, n) + lawn41.orgqr(m, n, n)))
    assert call.flops((3, m, n)) == pytest.approx(
        3 * (2 * m * n**2 - 2 * n**3 / 3 + 4 * m * n**2 - 2 * (m + n) * n**2 + 4 * n**3 / 3))
    # A read once, Q and R written once
    assert call.least_bytes((4096, 128, 128), 4) == 4 * 4096 * 3 * 128**2 == 805306368
    assert call.least_bytes((3, 200, 128), 4) == 4 * 3 * (2 * 200 * 128 + 128**2)

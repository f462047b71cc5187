"""``correct`` has to come out false for the control and for faults under
the timed path, each driven through a whole run (``run_cell``) on the CPU.

The control is the plain reference put in the program's place and
computed in TF32, the nearest precision below the configurations' IEEE
fp32 (``calibrate.py`` reads it at the cells' own sizes on the card); here
at the tiny sizes, against each real cell's limits. The same reference in
IEEE fp32 has to come out correct. The faults alter the program's answer
where it is produced, answer from the call before (a stale answer), or
raise."""

import io
import json
from types import SimpleNamespace

import pytest

import tileqr_torch
from qrbench import spec
from qrbench.run import run_cell
from qrbench.tests.conftest import CELLS

# the entry of tileqr_torch that each call module drives
ENTRY = {"qr_reduced": "qr", "tsqr_r": "tsqr", "tsqr_factor": "tsqr"}


def _raw(call: str, ans, a):
    """A judged answer as the entry returns it."""
    if call == "tsqr_factor":
        y, t, r = ans
        return SimpleNamespace(panels=((y, t),), shape=tuple(a.shape), r=r, scale=1.0)
    return ans


def _run(checkout, cell, seed=11):
    err = io.StringIO()
    res = run_cell(cell, seed, 0.3, False, device="cpu", root=checkout, out=io.StringIO(),
                   err=err)
    return res, err.getvalue()


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 3, 77])
@pytest.mark.parametrize("precision,correct", [("tf32", False), ("ieee", True)])
def test_the_reference_in_the_programs_place(checkout, monkeypatch, cell, seed, precision,
                                             correct):
    c = spec.cell(cell, checkout)
    ref = c.reference
    name = c.traffic["call"]

    def control(a, *args, **kw):
        return _raw(name, c.call.reference(ref, a, precision), a)
    monkeypatch.setattr(tileqr_torch, ENTRY[name], control)
    res, err = _run(checkout, cell, seed)
    assert res["correct"] is correct, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert ("FAILED" in err) is not correct


def test_calibrate_reads_program_and_control(checkout, capsys):
    from qrbench import calibrate

    calibrate.main(["--workload", "tall-tiny.cholqr2-factor", "--seeds", "5",
                    "--control-seeds", "6", "--extra", "fp32", "--device", "cpu",
                    "--root", str(checkout)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    sides = {x["summary"]: x for x in lines if "summary" in x}
    assert set(sides) == {"program", "fp32", "control"}
    limits = sides["program"]["limits"]
    assert all(sides["program"]["min_max"][k][1] <= v for k, v in limits.items())
    assert any(sides["control"]["min_max"][k][0] > v for k, v in limits.items())
    assert sides["program"]["n_correct"] == sides["fp32"]["n_correct"] == 1
    assert sides["control"]["n_correct"] == 0


def _altered(out):
    """One entry of the answer moved: R's by 1% of its largest entry, or
    T's first by 1%."""
    if hasattr(out, "panels"):
        y, t = out.panels[0]
        t = t.clone()
        t[0, 0] *= 1.01
        return out._replace(panels=((y, t),))
    if isinstance(out, tuple):
        q, r = out
        r = r.clone()
        r[0, -1] += 0.01 * r.abs().max()
        return q, r
    r = out.clone()
    r[0, -1] += 0.01 * r.abs().max()
    return r


def _stale():
    held = {}

    def fault(out):
        prev = held.get("out", out)
        held["out"] = out
        return prev
    return fault


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_fault_under_the_timed_path_is_not_correct(checkout, monkeypatch, cell, fault):
    entry = ENTRY[spec.cell(cell, checkout).traffic["call"]]
    orig = getattr(tileqr_torch, entry)
    wrap = _altered if fault == "altered" else _stale()
    monkeypatch.setattr(tileqr_torch, entry, lambda *a, **k: wrap(orig(*a, **k)))
    res, err = _run(checkout, cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] == 0
    assert "FAILED" in err


def test_a_call_that_raises_is_counted_failed(checkout, monkeypatch):
    orig, n = tileqr_torch.qr, [0]

    def flaky(*a, **k):
        n[0] += 1
        if n[0] > 2 and n[0] % 2:  # past the two warm calls, every other call
            raise RuntimeError("planted")
        return orig(*a, **k)
    monkeypatch.setattr(tileqr_torch, "qr", flaky)
    res, err = _run(checkout, "square-tiny.qr", seed=1)
    assert res["failed"] > 0 and res["attempted"] > res["failed"]
    assert res["correct"] is False
    assert "planted" in err

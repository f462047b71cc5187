"""The square hr cell of the benchmark (``square-16384-hr.qr``) on the CPU,
at small shapes: its input of prescribed condition
(``qrbench/inputs/prescribed_cond.py``), ``qr`` on the hr route judged
against the benchmark's float64 reference by the cell's own numbers, the
guard's health on that input, the route counter ``trace.HR_APPLY`` and
the launches against ``_hh_counts.planned_hr_counts`` (the 16384² plan
reckoned here without running it), the ``panel_apply_ms`` reader, and the
cell run end to end by the harness on a tiny copy of its configuration."""

import io
import json
import types

import pytest
import torch

import tileqr_torch as tq
from _hh_counts import planned_hr_counts
from qrbench import spec
from qrbench.calls import qr_reduced
from qrbench.inputs import prescribed_cond
from qrbench.reference import householder
from qrbench.run import run_cell
from qrbench.tests.conftest import make_checkout
from tileqr_torch.core import trace
from tileqr_torch.kernels import _build

CELL = "square-16384-hr.qr"
COND = 100.0
NB = 64


def _make(shape, dtype=torch.float32, seed=7, cond=COND):
    g = torch.Generator().manual_seed(seed)
    return prescribed_cond.make(shape, dtype, g, "cpu", cond, "geometric")


def _hr(**kw):
    return tq.QRConfig(nb=NB, square_method="hr", **kw)


@pytest.mark.parametrize("shape", [(256, 256), (320, 192), (192, 320)], ids=str)
def test_prescribed_cond_has_the_stated_singular_values(shape):
    """In float64 the singular values are σᵢ = cond^(−i/(k−1)) to 1e-12
    relative (the factors are orthonormal to float64 rounding); rounded
    to fp32 they move by about fp32's unit roundoff."""
    k = min(shape)
    want = prescribed_cond.sigma(k, COND)
    assert float(want[0]) == 1.0 and abs(float(want[-1]) - 1 / COND) <= 1e-15
    got = torch.linalg.svdvals(_make(shape, torch.float64))
    assert float(((got - want).abs() / want).max()) <= 1e-12
    got32 = torch.linalg.svdvals(_make(shape).double())
    assert float(((got32 - want).abs() / want).max()) <= 1e-4


def test_prescribed_cond_is_bitwise_the_same_from_one_seed():
    a, b = _make((256, 192)), _make((256, 192))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, _make((256, 192), seed=8))


def test_prescribed_cond_refuses_another_spectrum():
    with pytest.raises(ValueError, match="geometric"):
        prescribed_cond.make((64, 64), torch.float32, torch.Generator(), "cpu", COND, "flat")


# fp32 at these sizes: the program reads r_gap and resid ~6e-7 (about 10 u,
# u = 6e-8) and orth ~1.6e-5 (‖·‖F over k columns: √k·u·n^½ growth); the
# tolerances sit at ~5x, below what b3 (r_gap ~7e-6, resid ~9e-6, orth
# ~3e-4) and the TF32 reference (~7e-4, ~9e-4, ~0.02) read, so that both
# fail them. float64: the same algebra at float64 rounding (~1e-15 and
# ~2e-14 read).
TOL = {torch.float32: {"r_gap": 3e-6, "resid": 3e-6, "orth": 6e-5},
       torch.float64: {"r_gap": 1e-12, "resid": 1e-12, "orth": 1e-11}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape", [(512, 512), (320, 192)], ids=str)
def test_hr_qr_against_the_benchmark_reference(dtype, shape):
    a = _make(shape, dtype)
    got = qr_reduced.numbers(a, tq.qr(a, config=_hr(dtype=dtype)),
                             qr_reduced.truth(householder, a))
    assert set(got) == set(TOL[dtype])
    for key, tol in TOL[dtype].items():
        assert got[key] <= tol, (key, got[key])


def test_the_tolerances_fail_a_lower_precision():
    """The fp32 tolerances above are tight enough that the reference in
    TF32 and the program in its split-bf16 mode b3 fail every one."""
    a = _make((512, 512))
    r_ref = qr_reduced.truth(householder, a)
    for ans in (qr_reduced.reference(householder, a, "tf32"),
                tq.qr(a, config=_hr(precision="b3"))):
        got = qr_reduced.numbers(a, ans, r_ref)
        assert all(got[k] > tol for k, tol in TOL[torch.float32].items()), got


def test_the_guard_holds_far_below_tau_with_one_check():
    """Round 1's defect is about cond²·u = 6e-4 at worst; at these sizes it
    reads ~2e-6, far below hr_guard_tau = 0.05: one check a call, no trip."""
    a = _make((512, 512))
    cfg = _hr()
    f = tq.qr_factor(a, cfg)
    assert isinstance(f, tq.HRFactors) and float(f.health) <= 1e-4 < cfg.hr_guard_tau
    _build.reset_counts()
    tq.qr(a, config=cfg)
    assert trace.GUARD == {"qr_factor/hr": {"checks": 1, "trips": 0}}


def test_the_16384_plan():
    """The cell's call: 64 panels, 63 B6 launches (none past the last
    column), and Q's 64 applies: the 60 windows wider than 1024 columns on
    B7, the last 4 (1024 to 256 columns) by one torch product each; of
    the 123 fp32 phase-1 launches on 132 SMs, 60 on the balanced schedule
    with 7300 chains handed, 63 on the whole-tile grid (none in b3, whose
    phase 1 is the split kernel)."""
    assert planned_hr_counts(16384, 16384, 256) == {
        "panels": 64,
        "launches": {"potrf_batched": 64, "modified_lu": 64, "panel_apply_carry": 63,
                     "panel_apply": 60},
        "hr_apply": {"b7": 60, "pair": 0, "splitk": 0, "one": 4, "emulated": 0},
        "project": {"balanced": 60, "whole_tiles": 63, "handed": 7300}}
    b3 = planned_hr_counts(16384, 16384, 256, "b3")
    assert b3["launches"]["panel_apply_carry[b3]"] == 63 and b3["hr_apply"]["b7"] == 64
    assert not any(b3["project"].values())


@pytest.mark.parametrize("precision", ["highest", "b3"])
@pytest.mark.parametrize("shape", [(512, 512), (320, 192), (192, 320)], ids=str)
def test_counters_equal_the_plan(shape, precision):
    """On the CPU the plain versions count what the card would launch, and
    ``HR_APPLY`` the routes; a second reset clears the routes."""
    a = _make(shape)
    _build.reset_counts()
    tq.qr(a, config=_hr(precision=precision))
    want = planned_hr_counts(*shape, NB, precision)
    assert trace.HR_APPLY == want["hr_apply"]
    assert {k: v for k, v in _build.PLAIN_CALLS.items() if v} == want["launches"]
    assert not any(_build.LAUNCHES.values())
    assert sum(want["hr_apply"].values()) == -(-min(shape) // NB)
    _build.reset_counts()
    assert not any(trace.HR_APPLY.values())


def test_apply_q_counts_its_routes():
    """``apply_q`` on hr factors (a vector target: the narrow routes) counts
    one route an apply, in the reflectors' order."""
    a = _make((512, 512))
    f = tq.qr_factor(a, _hr())
    _build.reset_counts()
    tq.apply_q(f, a[:, :3], trans=True)
    assert sum(trace.HR_APPLY.values()) == 512 // NB and trace.HR_APPLY["b7"] == 0


def _rec(trace_=None):
    return types.SimpleNamespace(trace=trace_)


def test_panel_apply_ms_reads_b6_b7_groups_per_call():
    read = spec.load("metrics", "panel_apply_ms").read
    ops = [["panel apply B6/B7/B7a (phase 1)", 0.30],
           ["panel apply B6/B7 (phase 1's groups combined, op(T) folded in)", 0.02],
           ["C -= Y W: B6/B7/B7b phase 2 and K3 stage 3", 0.28],
           ["torch.matmul (cuBLAS)", 0.50], ["potrf_batched", 0.01]]
    t = {"n_calls": 2, "n_ops": 9, "breakdown": {"device_ops": ops, "idle_gaps": []}}
    assert read(_rec(t)) == pytest.approx(1e3 * 0.60 / 2)
    assert read(_rec(None)) is None
    assert read(_rec({"n_calls": 0})) is None
    assert read(_rec(dict(t, n_ops=0))) is None
    none = dict(t, breakdown={"device_ops": ops[3:], "idle_gaps": []})
    assert read(_rec(none)) is None


def test_the_cell_resolves_by_name():
    c = spec.cell(CELL)
    assert c.config["qrconfig"]["square_method"] == "hr"
    assert c.config["input"] == {"distribution": "prescribed_cond", "cond": COND,
                                 "spectrum": "geometric"}
    assert c.inputs.make is not None and c.call.BACKWARD == "resid"
    assert set(c.limits) == {"r_gap", "resid", "orth"}
    assert "panel_apply_ms" in {m["name"] for m in c.per_layer}
    bench = spec.benchmark()
    entry = [x for x in bench["configs"] if x["name"] == "square-16384-hr"][0]
    assert entry["reduced"] == [] == c.config["reduced"]


def test_a_tiny_copy_of_the_cell_runs_correct_through_the_harness(tmp_path, monkeypatch):
    """The cell's configuration at 256² (the shape the only change) through
    ``qrbench.run.run_cell`` on the CPU, traced and not: correct, with the
    cell's limits, and the guard silent."""
    from qrbench import run

    monkeypatch.setattr(run, "TRACE_SECONDS", 0.05)
    monkeypatch.setattr(run, "TRACE_CALLS", 2)
    root = make_checkout(tmp_path)
    cfg = json.loads((root / "qrbench/configs/square-16384-hr.json").read_text())
    cfg.update(name="square-hr-tiny", shape=[256, 256], qrconfig=dict(cfg["qrconfig"], nb=NB))
    (root / "qrbench/configs/square-hr-tiny.json").write_text(json.dumps(cfg))
    (root / "qrbench/limits/square-hr-tiny.qr.json").write_text(
        (root / f"qrbench/limits/{CELL}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "square-hr-tiny", "source": "test", "reduced": ["shape"],
                             "file": "qrbench/configs/square-hr-tiny.json", "why": "test"})
    bench["workloads"].append({"name": "square-hr-tiny.qr", "config": "square-hr-tiny",
                               "traffic": "qr", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _build.reset_counts()
    for traced in (False, True):
        res = run_cell("square-hr-tiny.qr", 2**31 + 11, 0.3, traced, device="cpu", root=root,
                       out=io.StringIO(), err=io.StringIO())
        assert res["correct"] is True and res["failed"] == 0, res
    assert trace.GUARD["qr_factor/hr"]["trips"] == 0


def test_the_cpu_loop_keeps_no_graphs():
    """On the CPU the panel loop runs eagerly every call and keeps nothing
    between calls; ``release_graphs`` is public and leaves the cache empty."""
    from tileqr_torch.drivers import square_hr

    tq.release_graphs()
    a = _make((256, 256))
    q0, r0 = tq.qr(a, config=_hr())
    q1, r1 = tq.qr(a, config=_hr())
    assert not square_hr._LOOPS
    assert torch.equal(q0, q1) and torch.equal(r0, r1)
    assert "release_graphs" in tq.__all__

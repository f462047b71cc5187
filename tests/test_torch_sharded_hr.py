"""tileqr_torch's hr sharded path (``qr_sharded`` with
``square_method="hr"``, ``assemble_r_sharded`` and ``apply_q_sharded`` on
``ShardedHRFactors``) in a (2, 2) gloo world of spawned CPU processes,
against tileqr's ``drivers/sharded_hr.py`` on the 8-virtual-device CPU
mesh (Pallas in interpret mode), on the same numpy inputs.

One world, spawned once for the module, runs every case: A 48×32 (k_max =
4 panels, nb = 8, tileqr's 8 segments clamped to 4) in float64, float32
"highest", "b3" and "high"; a ragged 44×27 A whose columns are padded
with α; the guard on a near-duplicate column and on a healthy A; tileqr's
factors carried in by ``interop``. tileqr's results are computed once per
module.

Tolerances:
- float64 R, Qᵀ·C and Q·C ≤ 1e-10 relative (the same algebra; the gram
  squares each panel's condition number); Q(QᵀC) = C to 1e-12;
- float32 "highest" ≤ 1e-4 max abs, the single-card hr bound
  (``tests/test_torch_square_hr.py``); measured 1.4e-6;
- float32 "b3" against tileqr's kernel route (B7's halves in interpret
  mode): relative Frobenius ≤ 1e-4, the b3 bound of
  ``tests/test_torch_precision_api.py``; measured 2.0e-6 (R) to 7.1e-6
  (Q·C), the b3 drift between the two packages recorded end to end for
  the square paths (the lo half is quantized at 2⁻¹⁷ of its operand,
  ROADMAP.md queue C);
- reruns, and r_diag/t_all/health across the ranks: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr.drivers import sharded_hr as jshr
from tileqr_torch.dist import launch
from tileqr_torch.interop import sharded_hr_factors_to_numpy

MESH = (2, 2)
A = np.random.default_rng(20).standard_normal((48, 32))
C = np.random.default_rng(21).standard_normal((48, 5))
RAGGED = np.random.default_rng(22).standard_normal((44, 27))
DUP = np.random.default_rng(23).standard_normal((48, 32)).astype(np.float32)
DUP[:, 1] = DUP[:, 0] * np.float32(1 + 1e-7)  # a near-duplicate column, as tileqr's test
TOL64 = 1e-10


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def jcfg(dt=np.float64, precision="highest"):
    return tileqr.QRConfig(nb=8, ib=8, mesh_shape=MESH, square_method="hr", precision=precision,
                           dtype=jnp.float64 if dt == np.float64 else jnp.float32)


def tcfg(dt=np.float64, precision="highest", **kw):
    return tileqr_torch.QRConfig(nb=8, ib=8, mesh_shape=MESH, square_method="hr",
                                 precision=precision,
                                 dtype=torch.float64 if dt == np.float64 else torch.float32, **kw)


def tileqr_hr(a, c, dt=np.float64, precision="highest"):
    """tileqr's hr sharded driver: factors, R, Qᵀ·C and Q·C."""
    mesh = jax.make_mesh(MESH, ("rows", "cols"))
    cfg = jcfg(dt, precision)
    f = jshr.qr_sharded_factor_hr(a.astype(dt), mesh, cfg)
    return dict(
        f=f, r=np.asarray(jshr.assemble_r_sharded_hr(f, mesh)),
        qtc=np.asarray(jshr.apply_q_sharded_hr(f, c.astype(dt), mesh, True, cfg)),
        qc=np.asarray(jshr.apply_q_sharded_hr(f, c.astype(dt), mesh, False, cfg)),
    )


@pytest.fixture(scope="module")
def ref():
    return {
        "f64": tileqr_hr(A, C),
        "f32": tileqr_hr(A, C, np.float32),
        "b3": tileqr_hr(A, C, np.float32, "b3"),
        "ragged": tileqr_hr(RAGGED, RAGGED),
    }


@pytest.fixture(scope="module")
def world(ref):
    f = ref["f64"]["f"]
    factors = {k: (tuple(np.asarray(y) for y in v) if k == "y_segs" else
                   np.asarray(v) if hasattr(v, "shape") else v) for k, v in f._asdict().items()}
    f32 = A.astype(np.float32), C.astype(np.float32)
    cases = [
        ("sharded_hr", dict(a=A, config=tcfg(), c=C, gather_factors=True)),
        ("sharded_hr", dict(a=f32[0], config=tcfg(np.float32), c=f32[1])),
        ("sharded_hr", dict(a=f32[0], config=tcfg(np.float32, "b3"), c=f32[1])),
        ("sharded_hr", dict(a=f32[0], config=tcfg(np.float32, "high"), c=f32[1])),
        ("sharded_hr", dict(a=RAGGED, config=tcfg())),
        ("sharded_hr_guard", dict(a=DUP, config=tcfg(np.float32))),
        ("sharded_hr_guard", dict(a=A.astype(np.float32), config=tcfg(np.float32))),
        ("sharded_hr_interop", dict(factors=factors, c=C, config=tcfg())),
    ]
    return launch.run_world(launch.run_cases, *MESH, kwargs=dict(cases=cases), timeout=300)


def check64(got, want, c):
    assert rel(got["r"], want["r"]) <= TOL64
    assert rel(got["qtc"], want["qtc"]) <= TOL64
    assert rel(got["qc"], want["qc"]) <= TOL64
    assert rel(got["qqtc"], c) <= 1e-12  # Q(QᵀC) = C


@pytest.mark.parametrize("case,key,c", [(0, "f64", C), (4, "ragged", RAGGED)],
                         ids=["48x32", "ragged-44x27"])
def test_float64_matches_tileqr(world, ref, case, key, c):
    got, want = world[case], ref[key]
    check64(got, want, c)
    assert tuple(got["segs"]) == tuple(want["f"].segs)
    assert abs(float(got["health"]) - float(want["f"].health)) <= 1e-12


def test_ragged_columns_padded_with_alpha_give_a_qr(world):
    """R of the α-padded ragged A against numpy's R up to row signs."""
    r = world[4]["r"]
    n = RAGGED.shape[1]
    _, r_np = np.linalg.qr(RAGGED)
    s = np.sign(np.diag(r_np)) * np.sign(np.diag(r[:n]))
    assert r.shape == RAGGED.shape and rel(r[:n] * s[:, None], r_np) <= 1e-12


@pytest.mark.parametrize("case,key", [(1, "f32"), (2, "b3")], ids=["highest", "b3"])
def test_float32_matches_tileqr(world, ref, case, key):
    got, want = world[case], ref[key]
    for name in ("r", "qtc", "qc"):
        if key == "f32":
            assert np.abs(got[name] - want[name]).max() <= 1e-4, name
        else:
            assert rel(got[name], want[name]) <= 1e-4, name


def test_high_is_b3_bitwise(world):
    """"high" takes B7's halves (b3's instantiation) on every panel, as the
    port's single-card hr apply; tileqr hands "high" to XLA
    (``tests/test_torch_sharded_hr_kernels.py`` records that)."""
    b3, high = world[2], world[3]
    for name in ("r", "qtc", "qc"):
        assert np.array_equal(b3[name], high[name])


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4], ids=["f64", "f32", "b3", "high", "ragged"])
def test_reruns_and_ranks_are_bitwise_equal(world, case):
    got = world[case]
    assert got["same"]  # the factor's rerun on rank 0
    assert len(set(got["replicated"])) == 1  # r_diag, t_all, health on all 4 ranks


@pytest.mark.parametrize("case,mode", [(0, "highest"), (1, "highest"), (2, "b3"), (3, "high")],
                         ids=["f64", "f32", "b3", "high"])
def test_factor_calls_follow_the_plan(world, case, mode):
    """Rank 0's plain-version calls against ``planned_launches_hr``: B9 and
    B8 on every panel, B7's halves on every panel in an emulated mode on
    float32 ("high" counts under b3's instantiation), none in "highest"
    (tileqr's plain routes); no kernel launch on the CPU."""
    got = world[case]
    assert not any(got["launches"].values())
    plain = {k: v for k, v in got["plain"].items() if v}
    plan = got["planned"]
    if case == 0:  # float64: never the kernel route
        plan = {k: v for k, v in plan.items() if not k.startswith("panel_")}
    assert plain == {k: v for k, v in plan.items() if v}
    assert plan["potrf_batched"] == plan["modified_lu"] == 4
    if mode != "highest":
        assert plain["panel_project[b3]"] == plain["panel_sub[b3]"] == 4


def test_guard_trips_and_falls_back_to_the_householder_driver(world):
    got = world[5]
    assert got["kind"] == "ShardedFactors"
    assert any("qr_sharded/hr" in w and "falling back" in w for w in got["warned"])
    assert np.array_equal(got["r"], got["r_hh"])


def test_guard_is_silent_on_a_healthy_input(world):
    got = world[6]
    assert got["kind"] == "ShardedHRFactors" and got["warned"] == []
    n = A.shape[1]
    s = np.sign(np.diag(got["r"])[:n]) * np.sign(np.diag(got["r_hh"])[:n])
    assert np.abs(got["r"][:n] * s[:, None] - got["r_hh"][:n]).max() <= 1e-4


def test_tileqr_factors_apply_in_the_port(world, ref):
    got, want = world[7], ref["f64"]
    assert rel(got["qtc"], want["qtc"]) <= TOL64
    assert rel(got["qc"], want["qc"]) <= TOL64
    assert rel(got["r"], want["r"]) <= TOL64


def test_port_factors_apply_in_tileqr(world):
    """Every rank's factors, to numpy and into tileqr's record, applied and
    assembled by tileqr's hr driver."""
    fs = [tileqr_torch.ShardedHRFactors(*(
        tuple(torch.as_tensor(y) for y in v) if i == 3 else
        torch.as_tensor(v) if isinstance(v, np.ndarray) else v for i, v in enumerate(x)))
        for x in world[0]["factors"]]
    d = sharded_hr_factors_to_numpy(fs)
    jf = jshr.ShardedHRFactors(**{
        k: (tuple(jnp.asarray(y) for y in v) if k == "y_segs" else
            jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()})
    mesh = jax.make_mesh(MESH, ("rows", "cols"))
    qtc = np.asarray(jshr.apply_q_sharded_hr(jf, C, mesh, True, jcfg()))
    assert rel(qtc, world[0]["qtc"]) <= TOL64
    assert rel(np.asarray(jshr.assemble_r_sharded_hr(jf, mesh)), world[0]["r"]) <= TOL64

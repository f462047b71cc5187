"""tileqr_torch's hr sharded path in a (4, 2) gloo world of spawned CPU
processes against tileqr's ``drivers/sharded_hr.py`` on the
8-virtual-device CPU mesh (Pallas in interpret mode), on the same numpy
inputs.

One world, spawned once for the module, runs every case: tileqr's own
deep rectangular case (``tests/test_sharded_hr.py::
test_hr_sharded_rectangular_deep``: 160×128, nb = 8, 16 panels over
segments=4, so segment slices of several sizes) in float64 and in float32
"b3", and a 64×48 A through ``qr_sharded`` (tileqr's 8 segments, clamped
to the 6 panels) in float64. tileqr's results are computed once per
module.

Tolerances: float64 R, Qᵀ·C and Q·C ≤ 1e-10 relative, Q(QᵀC) = C to
1e-12; float32 "b3" against tileqr's kernel route ≤ 1e-4 relative
Frobenius, the b3 bound of ``tests/test_torch_precision_api.py``
(measured 4.9e-6 (R) to 1.3e-5 (Q·C): the square paths' b3 drift);
reruns and r_diag/t_all/health across the 8 ranks bitwise.
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

MESH = (4, 2)
DEEP = np.random.default_rng(30).standard_normal((160, 128))
SQUARE = np.random.default_rng(31).standard_normal((64, 48))
C = np.random.default_rng(32).standard_normal((160, 3))
TOL64 = 1e-10


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def tileqr_hr(a, c, dt=np.float64, precision="highest", segments=8):
    mesh = jax.make_mesh(MESH, ("rows", "cols"))
    cfg = tileqr.QRConfig(nb=8, mesh_shape=MESH, square_method="hr", precision=precision,
                          dtype=jnp.float64 if dt == np.float64 else jnp.float32)
    f = jshr.qr_sharded_factor_hr(a.astype(dt), mesh, cfg, segments=segments)
    return dict(
        f=f, r=np.asarray(jshr.assemble_r_sharded_hr(f, mesh)),
        qtc=np.asarray(jshr.apply_q_sharded_hr(f, c.astype(dt), mesh, True, cfg)),
        qc=np.asarray(jshr.apply_q_sharded_hr(f, c.astype(dt), mesh, False, cfg)),
    )


def tcfg(dt=np.float64, precision="highest"):
    return tileqr_torch.QRConfig(nb=8, mesh_shape=MESH, square_method="hr", precision=precision,
                                 dtype=torch.float64 if dt == np.float64 else torch.float32)


@pytest.fixture(scope="module")
def ref():
    return {
        "deep": tileqr_hr(DEEP, C, segments=4),
        "deep_b3": tileqr_hr(DEEP, C, np.float32, "b3", segments=4),
        "square": tileqr_hr(SQUARE, SQUARE),
    }


@pytest.fixture(scope="module")
def world():
    f32 = DEEP.astype(np.float32), C.astype(np.float32)
    cases = [
        ("sharded_hr", dict(a=DEEP, config=tcfg(), c=C, segments=4)),
        ("sharded_hr", dict(a=f32[0], config=tcfg(np.float32, "b3"), c=f32[1], segments=4)),
        ("sharded_hr", dict(a=SQUARE, config=tcfg())),
    ]
    return launch.run_world(launch.run_cases, *MESH, kwargs=dict(cases=cases), timeout=300)


@pytest.mark.parametrize("case,key,c", [(0, "deep", C), (2, "square", SQUARE)],
                         ids=["deep-160x128-segments4", "square-64x48"])
def test_float64_matches_tileqr(world, ref, case, key, c):
    got, want = world[case], ref[key]
    assert tuple(got["segs"]) == tuple(want["f"].segs)
    assert rel(got["r"], want["r"]) <= TOL64
    assert rel(got["qtc"], want["qtc"]) <= TOL64
    assert rel(got["qc"], want["qc"]) <= TOL64
    assert rel(got["qqtc"], c) <= 1e-12
    assert abs(float(got["health"]) - float(want["f"].health)) <= 1e-12


def test_deep_segments_are_tileqrs():
    """16 panels over 4 segments on 4×2: slices start at local tile rows
    0, 0, 1, 2 and columns 0, 1, 3, 5."""
    assert jshr._seg_table(16, 4, 2, 4) == ((0, 4, 0, 0), (4, 8, 0, 1), (8, 12, 1, 3),
                                            (12, 16, 2, 5))


def test_b3_matches_tileqrs_kernel_route(world, ref):
    got, want = world[1], ref["deep_b3"]
    for name in ("r", "qtc", "qc"):
        assert rel(got[name], want[name]) <= 1e-4, name
    plain = got["plain"]
    assert plain["panel_project[b3]"] == plain["panel_sub[b3]"] == 16 == got["planned"][
        "panel_project[b3]"]


def test_r_is_a_qr(world):
    r = world[0]["r"]
    n = DEEP.shape[1]
    _, r_np = np.linalg.qr(DEEP)
    s = np.sign(np.diag(r_np)) * np.sign(np.diag(r[:n]))
    assert rel(r[:n] * s[:, None], r_np) <= 1e-12


@pytest.mark.parametrize("case", [0, 1, 2], ids=["deep-f64", "deep-b3", "square-f64"])
def test_reruns_and_all_8_ranks_are_bitwise_equal(world, case):
    got = world[case]
    assert got["same"] and len(got["replicated"]) == 8 and len(set(got["replicated"])) == 1

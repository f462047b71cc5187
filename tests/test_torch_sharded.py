"""tileqr_torch's sharded path (``qr_sharded``, ``assemble_r_sharded``,
``apply_q_sharded``) in gloo worlds of spawned CPU processes, against
tileqr's dynamic sharded driver on the 8-virtual-device CPU mesh (Pallas
in interpret mode), on the same numpy inputs.

Two worlds, each spawned once for the module (``tileqr_torch.dist.launch``;
the ranks import torch and tileqr_torch only), run every case: (2, 2) at
32×24 and (4, 2) at 64×48 (k_max = 6), nb = ib = 8, at chunk 1 (tileqr's
static driver's algebra) and chunk 2, plus the Mesh collectives, the
raises inside a world, the chunk rule of ``qr_sharded`` and the interop of
``ShardedDynFactors``. tileqr's results are computed once per module. The
port is held against the dynamic driver (at chunk 1 it equals the static
one, whose interpret run takes minutes); one ``slow`` test holds it against
the static driver itself.

Tolerances: float64 R, Qᵀ·C and Q·C ≤ 1e-10 relative (the same algebra, a
longer chain of products than one kernel); float32 ≤ 5e-6·max|R|
elementwise (tileqr's own dyn-vs-static gate); Q(QᵀC) = C to 1e-12 in
float64; reruns bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr.drivers import sharded as jsh
from tileqr.drivers import sharded_dyn as jdyn
from tileqr_torch.dist import launch
from tileqr_torch.dist.mesh import Mesh
from tileqr_torch.interop import sharded_factors_from_numpy, sharded_factors_to_numpy

TOL64 = 1e-10
A22 = np.random.default_rng(10).standard_normal((32, 24))
C22 = np.random.default_rng(11).standard_normal((32, 5))
A42 = np.random.default_rng(12).standard_normal((64, 48))


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def jcfg(mesh_shape, dt=np.float64, **kw):
    return tileqr.QRConfig(nb=8, ib=8, mesh_shape=mesh_shape,
                           dtype=jnp.float64 if dt == np.float64 else jnp.float32, **kw)


def tcfg(mesh_shape, dt=np.float64, **kw):
    return tileqr_torch.QRConfig(nb=8, ib=8, mesh_shape=mesh_shape,
                                 dtype=torch.float64 if dt == np.float64 else torch.float32, **kw)


def tileqr_dyn(a, mesh_shape, chunk, c=None, dt=np.float64):
    """tileqr's dynamic driver: factors, R, Qᵀ·A and Q·C."""
    mesh = jax.make_mesh(mesh_shape, ("rows", "cols"))
    cfg = jcfg(mesh_shape, dt, chunk=chunk)
    f = jdyn.qr_sharded_factor_dyn(a.astype(dt), mesh, cfg)
    c = a if c is None else c
    return dict(
        f=f, chunk=f.chunk, r=np.asarray(jdyn.assemble_r_sharded_dyn(f, mesh)),
        qta=np.asarray(jdyn.apply_q_sharded_dyn(f, a.astype(dt), mesh, True, cfg)),
        qc=np.asarray(jdyn.apply_q_sharded_dyn(f, c.astype(dt), mesh, False, cfg)),
        qtc=np.asarray(jdyn.apply_q_sharded_dyn(f, c.astype(dt), mesh, True, cfg)),
    )


@pytest.fixture(scope="module")
def ref():
    """tileqr's results, once per module."""
    return {
        "22c1": tileqr_dyn(A22, (2, 2), 1, C22),
        "22c2": tileqr_dyn(A22, (2, 2), 2, C22),
        "22f32": tileqr_dyn(A22, (2, 2), 2, dt=np.float32),
        "42c1": tileqr_dyn(A42, (4, 2), 1),
        "42c2": tileqr_dyn(A42, (4, 2), 4),
    }


@pytest.fixture(scope="module")
def world22(ref):
    """Every (2, 2) case in one spawned world; results in case order."""
    f = ref["22c2"]["f"]
    factors = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in f._asdict().items()}
    cases = [
        ("collectives", {}),
        ("raises", {}),
        ("sharded", dict(a=A22, config=tcfg((2, 2)), chunk=1, c=C22)),
        ("sharded", dict(a=A22, config=tcfg((2, 2)), chunk=2, c=C22, gather_factors=True)),
        ("sharded", dict(a=A22.astype(np.float32), config=tcfg((2, 2), np.float32), chunk=2)),
        ("sharded", dict(a=A22, config=tcfg((2, 2)))),  # the rule: auto → static → 1
        ("sharded", dict(a=A22, config=tcfg((2, 2), driver="dynamic", chunk=4))),
        ("interop", dict(factors=factors, c=C22, config=tcfg((2, 2)))),
    ]
    return launch.run_world(launch.run_cases, 2, 2, kwargs=dict(cases=cases), timeout=300)


@pytest.fixture(scope="module")
def world42():
    cases = [
        ("collectives", {}),
        ("sharded", dict(a=A42, config=tcfg((4, 2)), chunk=1)),
        ("sharded", dict(a=A42, config=tcfg((4, 2), driver="dynamic"))),  # chunk 4 → 2
    ]
    return launch.run_world(launch.run_cases, 4, 2, kwargs=dict(cases=cases), timeout=300)


# ---- the Mesh collectives ----

def check_collectives(ranks, pr, pc):
    from tileqr_torch.drivers.sharded import _roles, _tree_perms

    for rank, d in enumerate(ranks):
        r, c = divmod(rank, pc)
        assert tuple(d["coords"]) == (r, c)
        assert d["foreign_modules"] == []  # the ranks import no jax, jaxlib or tileqr
        # broadcast = psum of the masked value: the owner's tag, never the garbage
        assert [x[0] for x in d["bcast_cols"]] == [r * pc + o + 1 for o in range(pc)]
        assert [x[0] for x in d["bcast_both"]] == [q + 1 for q in range(pr * pc)]
        for r_k in range(pr):
            t_rot = (r - r_k) % pr
            for li, (down, up, dd) in enumerate(_tree_perms(pr, r_k)):
                root, leaf = _roles(t_rot, dd, pr)
                got_down = d["perms"][(r_k, li, "down")]
                got_up = d["perms"][(r_k, li, "up")]
                # down: the root side receives its leaf's tag, every other rank zeros
                want_down = (((r + dd) % pr) * pc + c + 1) if root else 0
                want_up = (((r - dd) % pr) * pc + c + 1) if leaf else 0
                assert np.all(got_down == want_down) and np.all(got_up == want_up)
        # all_gather order: axis index order
        assert list(d["gather_cols"][:, 0]) == [r * pc + j + 1 for j in range(pc)]
        assert list(d["gather_rows"][:, 0]) == [i * pc + c + 1 for i in range(pr)]
        # psum: the sum of the axis group's tags
        assert np.all(d["psum_cols"] == sum(r * pc + j + 1 for j in range(pc)))
        assert np.all(d["psum_rows"] == sum(i * pc + c + 1 for i in range(pr)))
        # bytes: a rank with no pair at a level makes no call and moves
        # nothing; a root or leaf sends or receives 24 bytes each way
        roles = sum(any(_roles((r - r_k) % pr, dd, pr))
                    for r_k in range(pr) for _, _, dd in _tree_perms(pr, r_k))
        assert d["moved"] == {"broadcast": 24 * (pc * (pc > 1) + pr * pc),
                              "ppermute": 48 * roles, "all_gather": 24 * (pc + pr),
                              "psum": 24 * ((pc > 1) + (pr > 1))}


def test_collectives_2x2(world22):
    check_collectives(world22[0], 2, 2)


def test_collectives_4x2_and_ranks_without_a_pair(world42):
    """pr = 4: at level d = 2 of every rotation two mesh rows have no pair
    (rows 1 and 3 when the root is row 0); they get zeros and make no call
    (check_collectives counts each rank's bytes by its roles)."""
    ranks = world42[0]
    check_collectives(ranks, 4, 2)
    for rank in (2, 3, 6, 7):
        assert not any(np.any(ranks[rank]["perms"][(0, 1, w)]) for w in ("down", "up"))


def test_raises_inside_a_world(world22):
    assert world22[1] == {"world": "ValueError", "hr": "ValueError"}


# ---- the path against tileqr's dynamic driver ----

def check_case(got, want, a, c=None):
    assert got["chunk"] == want["chunk"]
    assert rel(got["r"], want["r"]) <= TOL64
    assert rel(got["qta"], want["qta"]) <= TOL64
    assert rel(got["qc"], want["qc"]) <= TOL64
    c = a if c is None else c
    assert rel(got["qqtc"], c) <= 1e-12  # Q(QᵀC) = C
    assert np.array_equal(got["r"], got["r2"])  # rerun bitwise


@pytest.mark.parametrize("world,case", [("22", 2), ("22", 3), ("42", 1), ("42", 2)],
                         ids=["2x2-chunk1", "2x2-chunk2", "4x2-chunk1", "4x2-chunk2"])
def test_factor_calls_follow_the_plan(world22, world42, world, case):
    """Rank 0's plain-version calls in one factor against
    ``planned_launches``, one count per call, and no kernel launch."""
    got = (world22 if world == "22" else world42)[case]
    plan, plain = got["planned"], got["plain"]
    assert not any(got["launches"].values())
    assert {k: v for k, v in plain.items() if v} == {k: v for k, v in plan.items() if v}
    # k_max = min(mt, nt) with N padded to nb·pc: 24 → 32 on (2, 2)
    assert plan["panel_head"] == {"22": 4, "42": 6}[world]


@pytest.mark.parametrize("case,key", [(2, "22c1"), (3, "22c2")], ids=["chunk1", "chunk2"])
def test_2x2_matches_tileqr(world22, ref, case, key):
    check_case(world22[case], ref[key], A22, C22)


def test_2x2_float32_matches_tileqr(world22, ref):
    got, want = world22[4], ref["22f32"]
    scale = np.abs(want["r"]).max()
    assert np.abs(got["r"] - want["r"]).max() <= 5e-6 * scale
    assert np.abs(got["qta"] - want["qta"]).max() <= 5e-6 * scale
    assert np.array_equal(got["r"], got["r2"])


@pytest.mark.parametrize("case,key", [(1, "42c1"), (2, "42c2")], ids=["chunk1", "chunk2"])
def test_4x2_matches_tileqr(world42, ref, case, key):
    check_case(world42[case], ref[key], A42)


def test_4x2_r_is_a_qr(world42):
    """R against numpy's R up to row signs, and ‖QᵀA − R‖F/‖A‖F."""
    r = world42[1]["r"]
    n = A42.shape[1]
    _, r_np = np.linalg.qr(A42)
    s = np.sign(np.diag(r_np)) * np.sign(np.diag(r[:n]))
    assert rel(r[:n] * s[:, None], r_np) <= 1e-12
    assert np.linalg.norm(world42[1]["qta"] - r) / np.linalg.norm(A42) <= 1e-14


def test_chunk_rule_matches_tileqr_qr_sharded(world22, ref):
    """auto at ≤ 32 panels → tileqr's static driver → chunk 1, whose R the
    dynamic driver at chunk 1 matches; "dynamic" → tileqr.qr_sharded's own
    factors at min(chunk, local tile rows)."""
    auto, dyn = world22[5], world22[6]
    assert auto["chunk"] == 1 and tileqr_torch.QRConfig(nb=8).resolve_driver(32, 24) == "static"
    assert rel(auto["r"], ref["22c1"]["r"]) <= TOL64
    jf = tileqr.qr_sharded(A22, config=jcfg((2, 2), driver="dynamic", chunk=4), mode="factor")
    assert isinstance(jf, jdyn.ShardedDynFactors) and dyn["chunk"] == jf.chunk == 2
    assert rel(dyn["r"], np.asarray(jdyn.assemble_r_sharded_dyn(jf))) <= TOL64


def test_tileqr_factors_apply_in_the_port(world22, ref):
    got, want = world22[7], ref["22c2"]
    assert rel(got["qtc"], want["qtc"]) <= TOL64
    assert rel(got["qc"], want["qc"]) <= TOL64


def test_port_factors_apply_in_tileqr(world22, ref):
    """Every rank's factors, to numpy and into tileqr's record, applied by
    tileqr's dynamic driver."""
    d = sharded_factors_to_numpy([as_tensors(x) for x in world22[3]["factors"]])
    jf = jdyn.ShardedDynFactors(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                   for k, v in d.items()})
    mesh = jax.make_mesh((2, 2), ("rows", "cols"))
    qta = np.asarray(jdyn.apply_q_sharded_dyn(jf, A22, mesh, True, jcfg((2, 2))))
    assert rel(qta, world22[3]["qta"]) <= TOL64
    assert rel(np.asarray(jdyn.assemble_r_sharded_dyn(jf, mesh)), world22[3]["r"]) <= TOL64


def as_tensors(x):
    """A rank's ShardedFactors with numpy fields (from the world) → tensors."""
    return tileqr_torch.ShardedFactors(*(torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                                         for v in x))


# ---- in-process: the (1, 1) mesh and the raises ----

def test_1x1_mesh_without_a_process_group():
    assert not torch.distributed.is_initialized()
    chunk = 4
    a = np.random.default_rng(13).standard_normal((40, 24))
    cfg = tcfg((1, 1), driver="dynamic", chunk=chunk)
    f = tileqr_torch.qr_sharded(torch.tensor(a), config=cfg, mode="factor")
    want = tileqr_dyn(a, (1, 1), chunk)
    assert f.chunk == want["chunk"]
    assert rel(tileqr_torch.assemble_r_sharded(f), want["r"]) <= TOL64
    assert rel(tileqr_torch.apply_q_sharded(f, a, config=cfg), want["qta"]) <= TOL64
    assert rel(tileqr_torch.apply_q_sharded(f, a, trans=False, config=cfg), want["qc"]) <= TOL64
    back = sharded_factors_from_numpy(
        {k: (v[None, None] if k in ("local", "v_heads", "tg_all", "t2_heads", "v_chunks",
                                    "t2_chunks", "tree_v2", "tree_t2") else v)
         for k, v in launch.to_numpy(f._asdict()).items()}, (0, 0))
    assert all(torch.equal(x, y) for x, y in zip(back[:9], f[:9]))


@pytest.mark.parametrize("shape", [(8,), (2, 8, 8), (0, 8), (8, 0)])
def test_qr_sharded_rejects_bad_shapes(shape):
    with pytest.raises(ValueError, match="2-D matrix with no zero-size"):
        tileqr_torch.qr_sharded(np.zeros(shape), config=tcfg((1, 1)))


def test_qr_sharded_raises_without_cuda_or_group():
    a = np.random.default_rng(14).standard_normal((16, 16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tileqr_torch.qr_sharded(a, config=tcfg((1, 1)))
    with pytest.raises(RuntimeError, match="process group"):
        tileqr_torch.qr_sharded(torch.tensor(a), config=tcfg((2, 2)))
    fh = tileqr_torch.qr_sharded(torch.tensor(a), config=tcfg((1, 1), square_method="hr"),
                                 mode="factor")
    with pytest.raises(ValueError, match="c rows"):
        tileqr_torch.apply_q_sharded(fh, a[:8])
    with pytest.raises(ValueError, match="unknown mode"):
        tileqr_torch.qr_sharded(torch.tensor(a), config=tcfg((1, 1)), mode="reduced")
    with pytest.raises(ValueError, match="mesh"):
        Mesh(0, 2)


@pytest.mark.slow
def test_2x2_chunk1_matches_tileqr_static_driver(world22):
    """The static sharded driver itself (minutes in interpret mode)."""
    mesh = jax.make_mesh((2, 2), ("rows", "cols"))
    f = jsh.qr_sharded_factor(A22, mesh, jcfg((2, 2), chunk=1))
    r = np.asarray(jsh.assemble_r_sharded(f, mesh))
    assert rel(world22[2]["r"], r) <= TOL64

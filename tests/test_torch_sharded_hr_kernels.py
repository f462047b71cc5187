"""The sharded hr path's pieces in tileqr_torch (CPU) against tileqr's (JAX
on the CPU, Pallas in interpret mode), on the same numpy inputs: B7's
halves ``panel_project`` (B7a) and ``panel_sub`` (B7b) as plain versions,
the helpers of ``drivers/sharded_hr.py`` (``_seg_table``, ``pad_for_hr``
with row/column multiples, ``_cholqr2_psum``, ``_reconstruct_yt_dist``,
``_apply_panel_dist``'s routes) on a (1, 1) mesh, where tileqr's run
inside ``shard_map`` and the port's need no process group, and the launch
plan.

Tolerances, each with its reason:
- the halves in "b3"/"b4" float32: relative Frobenius ≤ 1e-5 (the same
  bf16 halves and exact products, the fp32 sums in another order; one
  emulated pass differs from another at ~1e-5); in "highest" float32
  ≤ 1e-6 (fp32 sums in another order over m/mr ≥ 2 Kahan row blocks);
- the halves in float64: the exact product in every mode, ≤ 1e-12 against
  numpy (tileqr's B7a holds its sum in float32 scratch, so its float64
  result is fp32-accurate and no reference);
- ``_seg_table``: equal; ``pad_for_hr``: ≤ 1e-12, the port's α an exact
  power of two (tileqr's ``exp2`` rounds on XLA:CPU, ROADMAP.md queue C);
- ``_cholqr2_psum``, ``_reconstruct_yt_dist``, the float64 routes of
  ``_apply_panel_dist``: ≤ 1e-10 (the same algebra; the gram squares the
  panel's condition number); float32 "highest" routes ≤ 1e-6; b3 ≤ 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import tileqr_torch
from tileqr.drivers import sharded_hr as jshr
from tileqr.drivers import square_hr as jsquare_hr
from tileqr.kernels import modlu as jmodlu
from tileqr.kernels import panel_apply as jpa
from tileqr_torch.dist.mesh import Mesh
from tileqr_torch.drivers import sharded_hr, square_hr
from tileqr_torch.kernels import _build, modlu, panel_apply

TOL = {"b3": 1e-5, "b4": 1e-5, "highest": 1e-6}
# (m, nb, n): m / _block(m, nb, 512) = 3 and 2 row blocks of the Kahan sum
SHAPES = [(1536, 64, 192), (640, 32, 96)]


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def t(x):
    return torch.tensor(np.asarray(x))


def inputs(m, nb, n, dt, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((m, nb)).astype(dt), g.standard_normal((m, n)).astype(dt),
            g.standard_normal((nb, n)).astype(dt))


def in_shard_map(fn, *args):
    """tileqr's function on the (1, 1) mesh, where its psums bind."""
    mesh = jax.make_mesh((1, 1), ("rows", "cols"))
    spec = tuple(P() for _ in args)
    out = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=P(), check_vma=False)(
        *(jnp.asarray(x) for x in args))
    return jax.tree_util.tree_map(np.asarray, out)


# ---- B7a panel_project and B7b panel_sub ----

@pytest.mark.parametrize("mode", ["b3", "b4", "highest"])
@pytest.mark.parametrize("m,nb,n", SHAPES, ids=["3blocks", "2blocks"])
def test_panel_project_matches_tileqr(m, nb, n, mode):
    y, c, _ = inputs(m, nb, n, np.float32)
    assert m // panel_apply._block(m, nb, 512) >= 2
    want = jpa.panel_project(jnp.asarray(y), jnp.asarray(c), mode, interpret=True)
    _build.reset_counts()
    got = panel_apply.panel_project(t(y), t(c), mode)
    assert _build.PLAIN_CALLS[f"panel_project{'' if mode == 'highest' else f'[{mode}]'}"] == 1
    assert got.shape == (nb, n) and rel(got, want) <= TOL[mode]


@pytest.mark.parametrize("mode", ["b3", "b4", "highest"])
@pytest.mark.parametrize("m,nb,n", SHAPES, ids=["3blocks", "2blocks"])
def test_panel_sub_matches_tileqr(m, nb, n, mode):
    y, c, w = inputs(m, nb, n, np.float32, seed=1)
    want = jpa.panel_sub(jnp.asarray(y), jnp.asarray(w), jnp.asarray(c), mode, interpret=True)
    ct = t(c)
    got = panel_apply.panel_sub(t(y), t(w), ct, mode)
    assert got is ct  # in place, as tileqr aliases C to the output
    assert rel(got, want) <= TOL[mode]


@pytest.mark.parametrize("mode", ["highest", "b3", "b4", "high", "default"])
def test_halves_are_exact_in_float64(mode):
    y, c, w = inputs(1536, 64, 192, np.float64, seed=2)
    assert rel(panel_apply.panel_project(t(y), t(c), mode), y.T @ c) <= 1e-12
    assert rel(panel_apply.panel_sub(t(y), t(w), t(c), mode), c - y @ w) <= 1e-12


def test_halves_are_phase_1_and_2_of_panel_apply():
    """project → op(T)·W → sub is B7 at the same row blocks (bitwise where
    B7's block, 1024 rows here, is B7a's 512: a 512-row C)."""
    y, c, _ = inputs(512, 64, 128, np.float32, seed=3)
    tt = np.triu(np.random.default_rng(4).standard_normal((64, 64))).astype(np.float32)
    for mode in ("highest", "b3"):
        want = panel_apply.panel_apply_plain(t(y), t(tt), t(c), trans=True, precision=mode)
        w = panel_apply.panel_project(t(y), t(c), mode)
        got = panel_apply.panel_sub(t(y), t(tt).T @ w, t(c), mode)
        assert torch.equal(got, want)


def test_halves_raise():
    y, c, w = (t(x) for x in inputs(64, 8, 16, np.float32))
    with pytest.raises(ValueError, match="c rows 56 != y rows 64"):
        panel_apply.panel_project(y, c[:56])
    with pytest.raises(ValueError, match="c rows 56 != y rows 64"):
        panel_apply.panel_sub(y, w, c[:56])
    with pytest.raises(ValueError, match="multiples of nb"):
        panel_apply.panel_project(y, c[:, :12])
    with pytest.raises(ValueError, match="precision"):
        panel_apply.panel_sub(y, w, c, "bf16")
    # the reference raises the same for c rows != y rows
    with pytest.raises(ValueError, match="c rows 56 != y rows 64"):
        jpa.panel_project(jnp.asarray(y.numpy()), jnp.asarray(c.numpy()[:56]), interpret=True)


# ---- the driver's helpers ----

def test_seg_table_matches_tileqr():
    for k_max in (1, 2, 5, 6, 16, 64):
        for pr, pc in ((1, 1), (2, 2), (4, 2), (2, 4)):
            for segments in (1, 3, 4, 8, 100):
                assert (sharded_hr._seg_table(k_max, pr, pc, segments)
                        == jshr._seg_table(k_max, pr, pc, segments))


@pytest.mark.parametrize("shape,rm,cm", [((60, 45), 16, 16), ((64, 48), 32, 16),
                                         ((40, 24), 16, 32), ((33, 17), None, 16)])
def test_pad_for_hr_with_multiples_matches_tileqr(shape, rm, cm):
    a = np.random.default_rng(5).standard_normal(shape) * 3.0
    jap, jshape = jsquare_hr.pad_for_hr(jnp.asarray(a), 8, row_mult=rm, col_mult=cm)
    ap, got_shape = square_hr.pad_for_hr(t(a), 8, row_mult=rm, col_mult=cm)
    assert tuple(ap.shape) == jap.shape and got_shape == tuple(jshape)
    assert rel(ap, jap) <= 1e-12
    m, n = shape
    if ap.shape[1] > n:
        alpha = float(ap[m, n])
        assert alpha == 2.0 ** np.ceil(np.log2(np.abs(a).max()))  # exact power of two
        assert torch.equal(ap[m : m + ap.shape[1] - n, n:],
                           alpha * torch.eye(ap.shape[1] - n, dtype=ap.dtype))


def test_cholqr2_psum_matches_tileqr():
    m, nb = 96, 16
    p = np.random.default_rng(6).standard_normal((m, nb))
    p[:16] = 0.0  # rows above the window, as the mask leaves them
    want = in_shard_map(lambda x: jshr._cholqr2_psum(x, nb, True), p)
    got = sharded_hr._cholqr2_psum(t(p), Mesh(1, 1))
    for name, g, w in zip(("q1", "w", "r"), got[:3], want[:3]):
        assert rel(g, w) <= 1e-10, name
    assert abs(float(got[3]) - float(want[3])) <= 1e-12


@pytest.mark.parametrize("owner", [True, False])
def test_reconstruct_yt_dist_matches_tileqr(owner):
    m, nb, top = 96, 16, 32
    q1, w, _, _ = sharded_hr._cholqr2_psum(
        t(np.random.default_rng(7).standard_normal((m, nb))), Mesh(1, 1))
    lu, d = modlu.modified_lu(q1[top : top + nb] @ w)
    want = in_shard_map(
        lambda *xs: jshr._reconstruct_yt_dist(*xs, top, jnp.asarray(float(owner)), nb),
        q1.numpy(), w.numpy(), lu.numpy(), d.numpy())
    got = sharded_hr._reconstruct_yt_dist(q1, w, lu, d, top, owner)
    assert rel(got[0], want[0]) <= 1e-10 and rel(got[1], want[1]) <= 1e-10
    assert torch.equal(got[0][top : top + nb], torch.tril(lu, -1) + torch.eye(nb,
                       dtype=lu.dtype)) == owner
    jlu, jd = jmodlu.modified_lu(jnp.asarray((q1[top : top + nb] @ w).numpy()), interpret=True)
    assert rel(lu, jlu) <= 1e-12 and rel(d, jd) == 0.0


def panel_pair(m, nb, seed):
    """(Y, T) of one float64 panel by the port's hr panel."""
    a = np.random.default_rng(seed).standard_normal((m, nb))
    y, tt, _ = square_hr.hr_panel(t(a))
    return y.numpy(), tt.numpy()


@pytest.mark.parametrize("m,n,route", [(4096, 16, "pairwise"), (4096, 1032, "split-K"),
                                       (256, 40, "one product")])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_apply_panel_dist_torch_routes_match_tileqr(m, n, route, dt):
    """tileqr's XLA routes in "highest", picked by the slice's local rows
    and columns."""
    y, tt = panel_pair(m, 8, m + n)
    c = np.random.default_rng(n).standard_normal((m, n))
    y, tt, c = y.astype(dt), tt.astype(dt), c.astype(dt)
    assert not sharded_hr._kernel_route("highest", torch.float32, m, n, 8)
    for trans in (True, False):
        want = in_shard_map(
            lambda yy, ttt, cc: jshr._apply_panel_dist(yy, ttt, cc, "highest", trans), y, tt, c)
        got = sharded_hr._apply_panel_dist(t(y), t(tt), t(c), Mesh(1, 1), "highest", trans)
        assert rel(got, want) <= (1e-10 if dt == np.float64 else 1e-6), route


def test_apply_panel_dist_b3_kernel_route_and_high():
    """b3 on an aligned float32 target takes B7's halves in both packages
    (tileqr's in interpret mode). "high" takes them too in the port, so it
    equals b3 bitwise; tileqr hands "high" to XLA (fp32 on the CPU), so its
    "high" is not its b3 (ROADMAP.md queue C: the port's rule, recorded)."""
    m, nb, n = 512, 16, 64
    y, tt = panel_pair(m, nb, 8)
    c = np.random.default_rng(9).standard_normal((m, n))
    y, tt, c = y.astype(np.float32), tt.astype(np.float32), c.astype(np.float32)
    out = {}
    for mode in ("b3", "high"):
        _build.reset_counts()
        out[mode] = sharded_hr._apply_panel_dist(t(y), t(tt), t(c), Mesh(1, 1), mode, True)
        assert _build.PLAIN_CALLS["panel_project[b3]"] == 1 == _build.PLAIN_CALLS["panel_sub[b3]"]
    assert torch.equal(out["b3"], out["high"])
    j = {mode: in_shard_map(
        lambda yy, ttt, cc, mode=mode: jshr._apply_panel_dist(yy, ttt, cc, mode, True, True),
        y, tt, c) for mode in ("b3", "high", "highest")}
    assert rel(out["b3"], j["b3"]) <= 1e-5
    assert rel(j["high"], j["highest"]) <= 1e-6 < rel(j["high"], j["b3"])


def test_planned_launches_hr():
    """Per factor: B9 and B8 on every panel; B7's halves where the
    segment's slice takes the kernel route: every panel in an emulated
    mode ("high" under b3's instantiation), none in "highest", whose
    updates take tileqr's plain routes."""
    plan = sharded_hr.planned_launches_hr((64, 64, 4, 2), 256, "highest")
    assert plan == dict(panel_project=0, panel_sub=0, potrf_batched=64, modified_lu=64)
    assert sharded_hr.planned_launches_hr((64, 64, 4, 2), 256, "high")["panel_project[b3]"] == 64
    plan = sharded_hr.planned_launches_hr((8, 8, 2, 1), 256, "b4")
    assert plan == {"panel_project[b4]": 8, "panel_sub[b4]": 8, "potrf_batched": 8,
                    "modified_lu": 8}
    # an apply: the halves only, at the C's local width
    assert sharded_hr.planned_launches_hr((64, 64, 4, 2), 256, "b3", cols=8192) == {
        "panel_project[b3]": 64, "panel_sub[b3]": 64}
    assert sharded_hr.planned_launches_hr((64, 64, 4, 2), 256, "highest", cols=8192) == dict(
        panel_project=0, panel_sub=0)


def test_1x1_mesh_matches_tileqr_and_routes_public_entries():
    """The hr sharded entries on a (1, 1) mesh with no process group:
    ``qr_sharded`` (factor and R), ``assemble_r_sharded`` and
    ``apply_q_sharded`` on ``ShardedHRFactors``, against tileqr's driver;
    tileqr's own ``apply_q_sharded`` refuses these factors (ROADMAP.md
    queue C), the port's takes them."""
    import tileqr

    a = np.random.default_rng(10).standard_normal((40, 24))
    cfg = tileqr_torch.QRConfig(nb=8, square_method="hr", dtype=torch.float64, mesh_shape=(1, 1))
    jcfg = tileqr.QRConfig(nb=8, square_method="hr", dtype=jnp.float64, mesh_shape=(1, 1))
    jf = tileqr.qr_sharded(a, config=jcfg, mode="factor")
    assert type(jf).__name__ == "ShardedHRFactors"
    with pytest.raises(AttributeError, match="panels"):
        tileqr.apply_q_sharded(jf, a, config=jcfg)
    f = tileqr_torch.qr_sharded(t(a), config=cfg, mode="factor")
    assert isinstance(f, tileqr_torch.ShardedHRFactors)
    assert rel(tileqr_torch.qr_sharded(t(a), config=cfg), np.asarray(tileqr.qr_sharded(
        a, config=jcfg))) <= 1e-10
    assert rel(tileqr_torch.assemble_r_sharded(f), np.asarray(jshr.assemble_r_sharded_hr(jf))) <= 1e-10
    for trans in (True, False):
        want = np.asarray(jshr.apply_q_sharded_hr(jf, a, trans=trans, config=jcfg))
        assert rel(tileqr_torch.apply_q_sharded(f, a, trans=trans, config=cfg), want) <= 1e-10

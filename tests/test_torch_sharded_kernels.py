"""The sharded path's kernels in tileqr_torch (plain versions, CPU) against
tileqr's Pallas kernels in interpret mode, on the same numpy inputs: TTQRT
and TTMQR (B15), the single-tile TSQRT, LARFB and SSRFB entries (B15),
``couple_apply`` (B14) and the panel head (B13); and the sharded driver's
layout helpers against tileqr's, bitwise.

Tolerances, relative Frobenius difference per output: float64 ≤ 1e-12 (the
same algebra, only the summation order differs), float32 ≤ 1e-5. The
windowed plain TTQRT against the plain TSQRT of the same couple: ≤ 1e-14
(torch's vectorised sums may group the non-zero terms differently once the
zeros past the window are gone).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import sharded as jsh
from tileqr.drivers import sharded_dyn as jdyn
from tileqr.kernels import larfb as jlarfb
from tileqr.kernels import panel as jpanel
from tileqr.kernels import ssrfb as jssrfb
from tileqr.kernels import tsqrt as jtsqrt
from tileqr.kernels import ttqrt as jttqrt
from tileqr.kernels import update as jupdate
from tileqr_torch.drivers import sharded
from tileqr_torch.kernels import _build, larfb, panel, ssrfb, tsqrt, ttqrt, update

TOL = {np.float64: 1e-12, np.float32: 1e-5}
TDT = {np.float64: torch.float64, np.float32: torch.float32}
CASES = [(nb, dt) for nb in (32, 64) for dt in (np.float64, np.float32)]
IDS = [f"nb{nb}-{dt.__name__}" for nb, dt in CASES]


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def t(x, dt):
    return torch.tensor(np.asarray(x), dtype=TDT[dt])


def tri_pair(nb, dt, seed=0):
    g = np.random.default_rng(seed)
    return (np.triu(g.standard_normal((nb, nb))).astype(dt),
            np.triu(g.standard_normal((nb, nb))).astype(dt))


@pytest.mark.parametrize("nb,dt", CASES + [(256, np.float32)], ids=IDS + ["nb256-float32"])
def test_ttqrt_matches_tileqr(nb, dt):
    """At nb = 256 tileqr's lane window is live too (384 of 512 lanes for
    the first ib = 128 block); below it only the port's nb + e window is."""
    r1, r2 = tri_pair(nb, dt)
    want = jttqrt.ttqrt(jnp.asarray(r1), jnp.asarray(r2), interpret=True)
    got = ttqrt.ttqrt(t(r1, dt), t(r2, dt))
    for name, g, w in zip(("r", "v2", "t2"), got, want):
        assert rel(g, w) <= TOL[dt], (name, rel(g, w))
    assert torch.equal(torch.tril(got[1], -1), torch.zeros_like(got[1]))  # V2 upper triangular


@pytest.mark.parametrize("nb,ib", [(32, 8), (64, 16), (64, 128)])
def test_ttqrt_window_equals_tsqrt(nb, ib):
    """The windowed column loop (rows past nb + e skipped) against the
    full-height TSQRT of the same couple."""
    r1, r2 = (t(x, np.float64) for x in tri_pair(nb, np.float64, seed=nb + ib))
    got = ttqrt.ttqrt_plain(r1, r2, ib)
    want = tsqrt.tsqrt(r1, r2, ib)
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel(g, w) <= 1e-14


@pytest.mark.parametrize("nb,dt", CASES, ids=IDS)
@pytest.mark.parametrize("trans", [True, False])
def test_ttmqr_matches_tileqr(nb, dt, trans):
    r1, r2 = tri_pair(nb, dt, seed=1)
    _, v2, t2 = jttqrt.ttqrt(jnp.asarray(r1), jnp.asarray(r2), interpret=True)
    g = np.random.default_rng(2)
    ct, cb = (g.standard_normal((nb, 3 * nb)).astype(dt) for _ in range(2))
    want = jttqrt.ttmqr(v2, t2, jnp.asarray(ct), jnp.asarray(cb), trans=trans, interpret=True)
    got = ttqrt.ttmqr(t(v2, dt), t(t2, dt), t(ct, dt), t(cb, dt), trans=trans)
    for g_, w in zip(got, want):
        assert rel(g_, w) <= TOL[dt]


@pytest.mark.parametrize("nb,dt", CASES, ids=IDS)
def test_tsqrt_matches_tileqr(nb, dt):
    g = np.random.default_rng(3)
    r = np.triu(g.standard_normal((nb, nb))).astype(dt)
    b = g.standard_normal((nb, nb)).astype(dt)
    want = jtsqrt.tsqrt(jnp.asarray(r), jnp.asarray(b), interpret=True)
    _build.reset_counts()
    got = tsqrt.tsqrt(t(r, dt), t(b, dt))
    assert _build.PLAIN_CALLS["panel_chain"] == 1 and sum(_build.PLAIN_CALLS.values()) == 1
    for g_, w in zip(got, want):
        assert g_.shape == w.shape and rel(g_, w) <= TOL[dt]


@pytest.mark.parametrize("nb,dt", CASES, ids=IDS)
@pytest.mark.parametrize("trans", [True, False])
def test_larfb_matches_tileqr(nb, dt, trans):
    g = np.random.default_rng(4)
    a = g.standard_normal((nb, nb)).astype(dt)
    c = g.standard_normal((nb, 2 * nb)).astype(dt)
    packed, tg = (np.asarray(x) for x in jpanel.panel_factor(
        jnp.asarray(a), 0, nb, ib=nb // 2, interpret=True)[1:3])
    packed = packed[0]
    want = jlarfb.larfb(jnp.asarray(packed), jnp.asarray(tg), jnp.asarray(c), trans=trans,
                        interpret=True)
    ct = t(c, dt)
    got = larfb.larfb(t(packed, dt), t(tg, dt), ct, trans=trans)
    assert rel(got, want) <= TOL[dt]
    assert torch.equal(ct, t(c, dt))  # C not written


@pytest.mark.parametrize("nb,dt", CASES, ids=IDS)
@pytest.mark.parametrize("trans", [True, False])
def test_ssrfb_matches_tileqr(nb, dt, trans):
    g = np.random.default_rng(5)
    r = np.triu(g.standard_normal((nb, nb))).astype(dt)
    b = g.standard_normal((nb, nb)).astype(dt)
    _, v2, t2 = (np.asarray(x) for x in jtsqrt.tsqrt(jnp.asarray(r), jnp.asarray(b),
                                                      interpret=True))
    ct, cb = g.standard_normal((nb, 3 * nb)).astype(dt), g.standard_normal((nb, 3 * nb)).astype(dt)
    want = jssrfb.ssrfb(jnp.asarray(v2), jnp.asarray(t2), jnp.asarray(ct), jnp.asarray(cb),
                        trans=trans, interpret=True)
    got = ssrfb.ssrfb(t(v2, dt), t(t2, dt), t(ct, dt), t(cb, dt), trans=trans)
    for g_, w in zip(got, want):
        assert rel(g_, w) <= TOL[dt]


@pytest.mark.parametrize("nb,dt", CASES[::2] + CASES[1:2], ids=IDS[::2] + IDS[1:2])
@pytest.mark.parametrize("trans,reverse", [(True, False), (False, True), (True, True)])
def test_couple_apply_matches_tileqr(nb, dt, trans, reverse):
    """B14 on panel 0 of a (4nb, 3nb) A, factored tile by tile (the static
    sharded driver's packed column), applied to column tiles 1 and 2."""
    a = np.random.default_rng(6).standard_normal((4 * nb, 3 * nb)).astype(dt)
    _, v_stack, tg, t2s = (np.asarray(x) for x in jpanel.panel_factor(
        jnp.asarray(a), 0, nb, ib=nb // 2, interpret=True))
    packed = v_stack.reshape(4 * nb, nb)
    want_c, want_s = jupdate.couple_apply(
        jnp.asarray(packed), jnp.asarray(tg), jnp.asarray(t2s), jnp.asarray(a), 0, 1, nb,
        trans=trans, reverse=reverse, interpret=True)
    c = t(a, dt)
    _build.reset_counts()
    got_c, got_s = update.couple_apply(t(packed, dt), t(tg, dt), t(t2s, dt), c, 0, 1, nb,
                                       trans=trans, reverse=reverse)
    assert _build.PLAIN_CALLS["couple_strip"] == 1 and got_c is c
    assert rel(got_s, want_s) <= TOL[dt]
    assert rel(got_c[nb:, nb:], np.asarray(want_c)[nb:, nb:]) <= TOL[dt]
    assert torch.equal(got_c[:nb], t(a, dt)[:nb])  # row tile k is returned apart


@pytest.mark.parametrize("nb,dt", CASES[:2], ids=IDS[:2])
@pytest.mark.parametrize("row_off,n_head", [(0, 0), (1, 2), (2, 1)])
def test_panel_head_matches_tileqr(nb, dt, row_off, n_head):
    """B13: K1 on rows [row_off, row_off + 1 + n_head) of a panel-column
    stack, written into the flat head buffers at slot head_base."""
    g = np.random.default_rng(7)
    pcol = g.standard_normal((5 * nb, nb)).astype(dt)
    slots, base = 8, 3
    vh0 = g.standard_normal((slots, nb, nb)).astype(dt)
    th0 = g.standard_normal((slots, nb, nb)).astype(dt)
    jr, jvh, jtg, jth = (np.asarray(x) for x in jdyn._panel_head_sh(
        jnp.asarray(pcol), jnp.asarray(vh0), jnp.asarray(th0), jnp.int32(row_off),
        jnp.int32(base), jnp.int32(1 + n_head), nb, nb // 2, True))
    vh, th = t(vh0, dt), t(th0, dt)
    r, tg = panel.panel_head(t(pcol, dt), row_off, n_head, vh, th, base, nb, nb // 2)
    assert rel(r, jr) <= TOL[dt] and rel(tg, jtg) <= TOL[dt]
    live = slice(base, base + 1 + n_head)
    assert rel(vh[live], jvh[live]) <= TOL[dt] and rel(th[live], jth[live]) <= TOL[dt]
    others = [i for i in range(slots) if not base <= i < base + 1 + n_head]
    assert torch.equal(vh[others], t(vh0, dt)[others])
    assert torch.equal(th[others], t(th0, dt)[others])


MESHES = [(2, 2), (4, 2), (1, 8)]


@pytest.mark.parametrize("pr,pc", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_layout_helpers_match_tileqr(pr, pc):
    nb = 4
    m, n = 3 * pr * nb, 2 * pc * nb
    a = np.arange(m * n, dtype=np.float64).reshape(m, n)
    want = np.asarray(jsh._to_local_layout(jnp.asarray(a), nb, pr, pc))
    got = sharded._to_local_layout(torch.tensor(a), nb, pr, pc)
    assert np.array_equal(got.numpy(), want)
    for r in range(pr):
        for c in range(pc):
            blk = sharded._local_block(torch.tensor(a), nb, pr, pc, r, c)
            assert np.array_equal(blk.numpy(), want[r, c])
    back = sharded._from_local_layout(got, nb).numpy()
    assert np.array_equal(back, np.asarray(jsh._from_local_layout(jnp.asarray(want), nb)))
    assert np.array_equal(back, a)


@pytest.mark.parametrize("pr,pc", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_geometry_helpers_match_tileqr(pr, pc):
    """_tree_perms for every r_k, _row_pad_tiles, _chunk_bases_sh and
    _local_geometry for every panel, mesh row and chunk."""
    for r_k in range(pr):
        assert sharded._tree_perms(pr, r_k) == jsh._tree_perms(pr, r_k)
    for lmt in (1, 2, 5, 8):
        for c in (1, 2, 3, 4):
            lmt_pad = sharded._row_pad_tiles(lmt, c)
            assert lmt_pad == jdyn._row_pad_tiles(lmt, c)
            k_max = lmt * pr
            assert sharded._chunk_bases_sh(lmt_pad, pr, c, k_max) == \
                tuple(jdyn._chunk_bases_sh(lmt_pad, pr, c, k_max))
            for k in range(k_max):
                for r in range(pr):
                    want = jdyn._local_geometry(jnp.int32(k), jnp.int32(r), lmt_pad, pr, c)
                    assert sharded._local_geometry(k, r, lmt_pad, pr, c) == \
                        tuple(int(x) for x in want)


def test_sharded_modules_leave_jax_out():
    """Importing the sharded path's modules (the dist layer, the driver and
    the new kernel modules) imports no jax, jaxlib or tileqr module."""
    code = (
        "import sys; before = set(sys.modules)\n"
        "import tileqr_torch.dist.mesh, tileqr_torch.dist.launch, tileqr_torch.drivers.sharded\n"
        "import tileqr_torch.kernels.ttqrt, tileqr_torch.kernels.tsqrt\n"
        "import tileqr_torch.kernels.update, tileqr_torch.interop\n"
        "import tileqr_torch.utils.sharded_errors\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'tileqr')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_sharded_errors_on_a_1x1_mesh(capsys):
    """``utils/sharded_errors.py`` in this process on the CPU: a (1, 1)
    mesh's fp32 errors at the hh path's scale, and its report line."""
    from tileqr_torch.dist.mesh import Mesh
    from tileqr_torch.utils import sharded_errors

    got = sharded_errors.errors_rank(Mesh(1, 1), n=64, nb=8, seed=3, device="cpu",
                                     driver="dynamic")
    assert got["chunk"] == 4
    assert got["relerr"] <= 1e-6 and got["resid"] <= 3e-6 and got["orth"] <= 1e-4
    assert sharded_errors.main(["--device", "cpu", "--n", "64", "--nb", "8",
                                "--meshes", "1x1", "--seed", "3"]) == 0
    assert "sharded 1x1 64x64 nb=8 chunk=1" in capsys.readouterr().out


@pytest.mark.parametrize("m,n,nb,driver", [(8192, 8192, 256, "auto"), (8448, 8192, 256, "auto"),
                                           (16384, 16384, 256, "auto"), (32, 24, 8, "auto"),
                                           (300, 260, 8, "auto"), (64, 48, 8, "dynamic"),
                                           (16384, 16384, 256, "static")])
def test_resolve_driver_matches_tileqr(m, n, nb, driver):
    """The rule qr_sharded picks its couple height by (chunk 1 where
    tileqr takes its static sharded driver)."""
    import tileqr
    import tileqr_torch

    want = tileqr.QRConfig(nb=nb, driver=driver).resolve_driver(m, n)
    assert tileqr_torch.QRConfig(nb=nb, driver=driver).resolve_driver(m, n) == want
    assert tileqr_torch.QRConfig.AUTO_STATIC_MAX_PANELS == tileqr.QRConfig.AUTO_STATIC_MAX_PANELS

"""The batched GEQRT's tall route (``csrc/geqrt_tall.cu``) on the CPU: a
float64 model of its order of operations, its schedule and its plan.

- A float64 model of the kernel: ``tall_schedule``'s operations in order on
  one matrix, in place, row-major: each panel of w columns factored with
  the kernel's column loop (a column's LARFG, its rank-1 dots and G's
  column from the dots of every panel column with the unscaled column,
  summed before the column is scaled; the head row posted by its owner),
  the panel's T by rows (larft); every update W = V1ᵀC (over runs of 256
  rows, then added in order), W2 = T1ᵀW, C −= V1·W2; every join Zᵀ =
  V2ᵀV1 (runs of 256 rows), M = Z·T2, T12 = −T1·M. Held against tileqr's
  ``tall_geqrt`` in interpret mode and against ``geqrt_batched_plain``, to
  1e-12: a 256×32 leaf at ib 16 and w 8, ragged last panels (a block
  narrower than ib and an ib that is not a multiple of w), a stack of four
  upper triangles (the tree's level-1 structure) and an n = 8 leaf of 2048
  rows (runs of 256 rows that end inside the matrix).
- ``tall_schedule``: every column factored once, in order; every update
  reaches exactly the columns right of its reflectors inside its block (or
  the block's trailing columns); the joins cover every entry of T above
  the diagonal blocks exactly once.
- ``tall_plan``: every shape the route takes fits one CTA's 227 KB, two
  leaves an SM only where two fit; the grid follows the SM count; m < n and
  panels past shared memory are refused (None); bad arguments raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import tsqr as jtsqr
from tileqr_torch.kernels import geqrt
from tileqr_torch.kernels._build import SMEM_LIMIT

H100_SMS = 132


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


# ---- a float64 model of csrc/geqrt_tall.cu ----

def chunked_tn(x, y, run=geqrt.TALL_KCHUNK):
    """xᵀ y over the rows, as partial sums over runs of ``run`` rows added in
    order (f32_tile with KC)."""
    tot = np.zeros((x.shape[1], y.shape[1]))
    for k0 in range(0, x.shape[0], run):
        tot = tot + x[k0:k0 + run].T @ y[k0:k0 + run]
    return tot


def unit_v(p, c0, h, r0):
    """V's columns [c0, c0 + h) on rows [r0, m): the stored reflectors with
    their unit diagonal and zero triangle (f32_tile's ``unit`` mask)."""
    v = p[r0:, c0:c0 + h].copy()
    rows = np.arange(r0, p.shape[0])[:, None]
    cols = np.arange(c0, c0 + h)[None, :]
    return np.where(rows == cols, 1.0, np.where(rows > cols, v, 0.0))


def model_panel(p, t, c0, wp):
    """The column loop of the panel [c0, c0 + wp) on rows [c0, m), then its T."""
    pan = p[c0:, c0:c0 + wp].copy()
    part = pan[1:].T @ pan[1:, 0]  # every column's dot with column 0's tail
    head = pan[0].copy()
    g = np.zeros((wp, wp))
    tau = np.zeros(wp)
    cols = np.arange(wp)
    for jj in range(wp):
        alpha, tailsq = head[jj], part[jj]
        sgn = 1.0 if alpha >= 0 else -1.0
        nrm = np.sqrt(alpha * alpha + tailsq)
        has_tail = tailsq > 0
        beta = -sgn * nrm if has_tail else alpha
        tj = (beta - alpha) / beta if has_tail else 0.0
        scale = 1.0 / (alpha - beta) if has_tail else 0.0
        d = head + scale * part  # vᵀ y for every column
        tw = np.where(cols > jj, tj * d, 0.0)
        g[:jj, jj] = d[:jj]
        tau[jj] = tj
        pan[jj + 1:, jj] *= scale
        pan[jj + 1:, jj + 1:] -= np.outer(pan[jj + 1:, jj], tw[jj + 1:])
        pan[jj, jj] = beta
        pan[jj, jj + 1:] -= tw[jj + 1:]
        if jj + 1 < wp:
            part = pan[jj + 2:].T @ pan[jj + 2:, jj + 1]
            head = pan[jj + 1].copy()
    p[c0:, c0:c0 + wp] = pan
    tp = np.zeros((wp, wp))
    for i in range(wp):
        tp[i, i] = tau[i]
        for j in range(i + 1, wp):
            tp[i, j] = -tau[j] * np.dot(tp[i, i:j], g[i:j, j])
    t[c0:c0 + wp, c0:c0 + wp] = tp


def model_update(p, t, c0, h1, h2):
    c1 = c0 + h1
    v = unit_v(p, c0, h1, c0)
    c = p[c0:, c1:c1 + h2]
    w1 = chunked_tn(v, c)
    w2 = t[c0:c1, c0:c1].T @ w1
    p[c0:, c1:c1 + h2] = c - v @ w2


def model_join(p, t, c0, h1, h2):
    c1 = c0 + h1
    zt = chunked_tn(unit_v(p, c1, h2, c1), p[c1:, c0:c1])
    mz = zt.T @ t[c1:c1 + h2, c1:c1 + h2]
    t[c0:c1, c1:c1 + h2] = -(t[c0:c1, c0:c1] @ mz)


def tall_model(a, ib, w):
    """(packed, T) of one (m, n) matrix, m ≥ n, in the tall route's order."""
    p = np.array(a, np.float64)
    n = p.shape[1]
    t = np.zeros((n, n))
    for kind, c0, h1, h2 in geqrt.tall_schedule(n, ib, w):
        if kind == geqrt.OP_PANEL:
            model_panel(p, t, c0, h1)
        elif kind in (geqrt.OP_UPDATE, geqrt.OP_TRAIL):
            model_update(p, t, c0, h1, h2)
        else:
            model_join(p, t, c0, h1, h2)
    return p, t


def tileqr_tall(stack, ib):
    """tileqr's tall_geqrt (interpret mode) on a (b, m, n) float64 stack."""
    b, m, n = stack.shape
    pk, t = jtsqr.tall_geqrt(jnp.asarray(stack.reshape(b * m, n)), m, ib, interpret=True)
    return np.asarray(pk).reshape(b, m, n), np.asarray(t)


def upper_stack(rng, k, n):
    return np.concatenate([np.triu(rng.standard_normal((n, n))) for _ in range(k)])


# (label, (b, m, n), ib, w, maker)
MODEL_CASES = {
    "leaf-256x32-ib16-w8": ((1, 256, 32), 16, 8, None),
    "ragged-block-200x44-ib32-w8": ((2, 200, 44), 32, 8, None),
    "ragged-panel-96x40-ib20-w8": ((1, 96, 40), 20, 8, None),
    "level1-4x32-upper-ib16-w8": ((1, 128, 32), 16, 8, "upper"),
    "n8-leaf-2048-ib8-w8": ((1, 2048, 8), 8, 8, None),
    "w16-160x48-ib32": ((1, 160, 48), 32, 16, None),
}


@pytest.mark.parametrize("case", list(MODEL_CASES), ids=str)
def test_tall_model_is_tileqrs_tall_geqrt(case):
    (b, m, n), ib, w, maker = MODEL_CASES[case]
    rng = np.random.default_rng(m + n + ib)
    if maker == "upper":
        stack = np.stack([upper_stack(rng, m // n, n) for _ in range(b)])
    else:
        stack = rng.standard_normal((b, m, n))
    got = [tall_model(x, ib, w) for x in stack]
    pk = np.stack([g[0] for g in got])
    t = np.stack([g[1] for g in got])
    want_pk, want_t = tileqr_tall(stack, ib)
    assert rel(pk, want_pk) <= 1e-12
    assert rel(t, want_t) <= 1e-12
    plain_pk, plain_t = geqrt.geqrt_batched_plain(torch.from_numpy(stack), ib)
    assert rel(pk, plain_pk) <= 1e-12
    assert rel(t, plain_t) <= 1e-12
    assert not np.tril(t, -1).any()


# ---- the schedule ----

@pytest.mark.parametrize("n,ib,w", [(512, 128, 16), (512, 128, 8), (256, 128, 32), (44, 32, 8),
                                    (40, 20, 8), (8, 8, 8), (37, 128, 16), (100, 16, 32)],
                         ids=str)
def test_tall_schedule_covers_every_column_and_block(n, ib, w):
    ops = geqrt.tall_schedule(n, ib, w)
    done = np.zeros(n, bool)
    covered = np.zeros((n, n), int)
    for kind, c0, h1, h2 in ops:
        if kind == geqrt.OP_PANEL:
            assert not done[c0:c0 + h1].any() and done[:c0].all()  # once, in order
            assert 1 <= h1 <= min(w, ib) and h2 == 0
            assert c0 // ib == (c0 + h1 - 1) // ib  # inside one block
            done[c0:c0 + h1] = True
            covered[c0:c0 + h1, c0:c0 + h1] += np.triu(np.ones((h1, h1), int))
            continue
        c1 = c0 + h1
        assert done[c0:c1].all() and h1 >= 1 and h2 >= 1
        if kind == geqrt.OP_UPDATE:
            # the right half of a split inside one block, not yet factored
            assert c0 // ib == (c1 + h2 - 1) // ib and not done[c1:c1 + h2].any()
        elif kind == geqrt.OP_TRAIL:
            s = c0
            assert s % ib == 0 and c1 == min(s + ib, n) and c1 + h2 == n
        else:
            assert done[c1:c1 + h2].all()
            covered[c0:c1, c1:c1 + h2] += 1
            if kind == geqrt.OP_JOIN_BLOCK:
                assert c0 == 0 and c1 % ib == 0
    assert done.all()
    assert (covered[np.triu_indices(n)] == 1).all() and not np.tril(covered, -1).any()


def test_tall_schedule_raises():
    with pytest.raises(ValueError, match="tall_schedule"):
        geqrt.tall_schedule(0, 128, 16)


# ---- the plan ----

@pytest.mark.parametrize("m", [8, 64, 256, 1000, 2048, 4096, 6000, 7000, 14000, 29000])
@pytest.mark.parametrize("n", [8, 33, 128, 512])
def test_tall_plan_fits_one_cta(m, n):
    for b in (1, 67, 512):
        plan = geqrt.tall_plan(b, m, n, 128, H100_SMS)
        if m < n:
            assert plan is None
            continue
        if plan is None:  # even 8 columns are past one CTA
            assert geqrt.tall_smem_bytes(m, 8) > SMEM_LIMIT
            continue
        assert plan.smem_bytes == geqrt.tall_smem_bytes(m, plan.w) <= SMEM_LIMIT
        assert plan.w in geqrt.TALL_WIDTHS and plan.w <= max(8, min(128, n))
        # the widest width that fits
        wider = [w for w in geqrt.TALL_WIDTHS if plan.w < w <= max(8, min(128, n))]
        assert all(geqrt.tall_smem_bytes(m, w) > SMEM_LIMIT for w in wider)
        assert plan.grid == min(b, H100_SMS)
        assert (plan.ctas, plan.threads, plan.ib) == (1, 256, 128)


def test_tall_plan_at_the_tsqr_shapes():
    leaves = geqrt.tall_plan(512, 2048, 512, 128, H100_SMS)
    assert (leaves.w, leaves.grid) == (16, 132)
    level1 = geqrt.tall_plan(128, 2048, 512, 128, H100_SMS)
    assert (level1.w, level1.grid) == (16, 128)
    tile = geqrt.tall_plan(4096, 256, 256, 128, H100_SMS)
    assert (tile.w, tile.grid) == (16, 132)
    # past 3.5k rows a 16-column panel is past one CTA
    assert geqrt.tall_plan(512, 4096, 512, 128, H100_SMS).w == 8
    # n = 8 leaves of 131072 rows: a panel of 8 columns is 4 MiB
    assert geqrt.tall_plan(200, 131072, 8, 8, H100_SMS) is None


@pytest.mark.parametrize("sms", [1, 16, 78, 132, 144])
def test_tall_plan_follows_the_sm_count(sms):
    for b in (1, 100, 4096):
        plan = geqrt.tall_plan(b, 2048, 512, 128, sms)
        assert plan.grid == min(b, sms)
        assert plan[:4] == geqrt.tall_plan(b, 2048, 512, 128, 132)[:4]


@pytest.mark.parametrize("args", [(0, 64, 8, 8, 132), (1, 0, 8, 8, 132), (1, 64, 0, 8, 132),
                                  (1, 64, 8, 0, 132), (1, 64, 8, 8, 0)],
                         ids=["no-batch", "no-rows", "no-cols", "no-ib", "no-sms"])
def test_tall_plan_raises(args):
    with pytest.raises(ValueError, match="tall_plan"):
        geqrt.tall_plan(*args)


@pytest.mark.parametrize("m,w", [(2048, 16), (1000, 16), (2048, 8), (4096, 8)])
def test_tall_smem_bytes_counts_the_panel(m, w):
    assert geqrt.tall_smem_bytes(m, w) == 4 * (m * w + 2 * 8 * w + 2 * w + 2 * w * w + w)


@pytest.mark.parametrize("m,w", [(64, 8), (256, 16), (100, 16)])
def test_tall_smem_bytes_holds_the_products_ring(m, w):
    # a short panel still holds the 128 x 128 product's ring
    assert geqrt.tall_smem_bytes(m, w) == 3 * 4 * (128 * 20 + 16 * 128)

"""The batched GEQRT's small route (``csrc/geqrt_small.cu``) on the CPU:
its T recurrence, its order of operations and its shared bytes.

- ``kernels/geqrt.py:t_from_gram``, LAPACK's column recurrence
  T[0:j, j] = −τ_j T[0:j, 0:j] G[0:j, j] that the kernel runs on each ib
  block, against the T of tileqr's batched GEQRT (doubling, interpret
  mode) in float64 to 1e-12: on each block from its own reflectors, and
  on the whole matrix at once (the blocked T, off-diagonal blocks
  −T1 (V1ᵀV2) T2 included, is the T of all the reflectors), at ib 32 and
  128 with a ragged last block.
- A float64 model of the kernel's order (the column loop with each
  reflector written a step late and, within each 32-column T sub-block,
  G's entries from the same dots, taken from the unscaled column; each
  sub-block's T by rows after the column loop, then joined to the
  sub-blocks before it by −T1 (V1ᵀV2) T2; the block apply and Z·T_b in
  one routine, the off-diagonal T in place top down in chunks, T packed
  as its upper triangle) against tileqr in interpret mode and the plain
  version, to 1e-12: the kernel's phases compute the JAX body's function.
- The shared bytes: every shape the route takes fits one H100 CTA, and
  a 128² matrix leaves room for two CTAs an SM; the tile's row stride is
  a multiple of 4 floats ≥ 128 whose quarter is odd (float4 rows, no bank
  conflict across 8 columns, the column loop's 128 rows in every row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import batched as jbatched
from tileqr_torch.kernels import geqrt
from tileqr_torch.kernels._build import SMEM_LIMIT


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def tileqr_geqrt(a, ib):
    """tileqr's batched GEQRT of one float64 (m, n) at ib: (packed, T)."""
    x = jnp.asarray(a[None])
    if ib == 128:
        pk, t = jbatched.geqrt_batched(x, interpret=True)
    else:
        pk, t = jbatched.geqrt_batched_grouped(x, group=1, ib=ib, interpret=True)
    return np.asarray(pk)[0], np.asarray(t)[0]


@pytest.mark.parametrize("m,n,ib", [(96, 72, 32), (160, 136, 128), (72, 40, 128)], ids=str)
def test_t_from_gram_is_tileqrs_t(m, n, ib):
    a = np.random.default_rng(m + n).standard_normal((m, n))
    pk, t = tileqr_geqrt(a, ib)
    v = np.tril(pk, -1) + np.eye(m, n)
    tau = np.diag(t).copy()
    for s in range(0, n, ib):
        e = min(n, s + ib)
        got = geqrt.t_from_gram(torch.tensor(v[:, s:e].T @ v[:, s:e]), torch.tensor(tau[s:e]))
        assert rel(got, t[s:e, s:e]) <= 1e-12
    got = geqrt.t_from_gram(torch.tensor(v.T @ v), torch.tensor(tau))
    assert rel(got, t) <= 1e-12


def test_t_from_gram_batches_over_leading_dims():
    rng = np.random.default_rng(3)
    g = torch.tensor(rng.standard_normal((2, 3, 8, 8)))
    tau = torch.tensor(rng.standard_normal((2, 3, 8)))
    got = geqrt.t_from_gram(g, tau)
    for i in range(2):
        for j in range(3):
            assert rel(got[i, j], geqrt.t_from_gram(g[i, j], tau[i, j])) <= 1e-14
    assert not torch.tril(got, -1).any()


# ---- a float64 model of csrc/geqrt_small.cu ----

def tix(i, j, kc):
    return i * (2 * kc - i - 1) // 2 + j


def small_model(a, ib, chunk):
    """The kernel's phases on one float64 (m, n): (packed, T). ``chunk``:
    outputs per in-place chunk of the off-diagonal T (NT·R on the card)."""
    m, n = a.shape
    kc = min(m, n)
    tb = geqrt.SMALL_T_SUB
    at = a.T.copy()
    tp = np.full(kc * (kc + 1) // 2, np.nan)
    red = [np.sum(at[0, 1:] ** 2), np.nan]
    gsub = {}  # G(l, j) within each T sub-block, block-relative indices

    def t_rows(s, ibk):  # a row a thread: row i needs only row i and G
        for i in range(ibk):
            q0 = i - i % tb
            for j in range(i + 1, min(q0 + tb, ibk)):
                acc = sum(tp[tix(s + i, s + l, kc)] * gsub[l, j] for l in range(i, j))
                tp[tix(s + i, s + j, kc)] = -tp[tix(s + j, s + j, kc)] * acc

    def z_times_t(p0, s, w):  # W2 = (V[:, p0:s]ᵀ V_b) T_b at T(c, s + k), rows >= s
        vb = np.array([[at[s + k, r] if r > s + k else float(r == s + k) for k in range(w)]
                       for r in range(s, m)])
        tbk = np.array([[tp[tix(s + l, s + k, kc)] if k >= l else 0.0 for k in range(w)]
                        for l in range(w)])
        for c in range(p0, s):
            w2 = (at[c, s:] @ vb) @ tbk
            for k in range(w):
                tp[tix(c, s + k, kc)] = w2[k]
        return vb, tbk

    def offdiag(p0, s, w):  # in place, top down in chunks
        outs = (s - p0) * w
        for o0 in range(0, outs, chunk):
            res = {}
            for o in range(o0, min(outs, o0 + chunk)):
                i, k = p0 + o // w, o % w
                res[(i, k)] = -sum(tp[tix(i, l, kc)] * tp[tix(l, s + k, kc)] for l in range(i, s))
            for (i, k), val in res.items():
                tp[tix(i, s + k, kc)] = val

    for s in range(0, kc, ib):
        ibk = min(ib, kc - s)
        pbeta = pscale = 0.0
        for jj in range(ibk):
            j = s + jj
            x = at[j]
            alpha, tailsq = x[j], red[j & 1]
            has = tailsq > 0
            beta = -(1.0 if alpha >= 0 else -1.0) * np.sqrt(alpha * alpha + tailsq) if has else alpha
            tau = (beta - alpha) / beta if has else 0.0
            scale = 1.0 / (alpha - beta) if has else 0.0
            tp[tix(j, j, kc)] = tau
            v = np.concatenate([[1.0], x[j + 1:] * scale])  # rows j..m-1
            sb = jj - jj % tb
            if jj:  # the previous reflector, a step late
                at[j - 1, j:] *= pscale
                at[j - 1, j - 1] = pbeta
            for cc in range(ibk):
                if cc == jj or cc < sb:
                    continue
                c = s + cc
                y = at[c]
                d = y[j] + scale * (y[j + 1:] @ x[j + 1:])  # from the unscaled column
                if cc < jj:
                    gsub[cc, jj] = d
                    continue
                y[j:] -= tau * d * v
                if cc == jj + 1:
                    red[c & 1] = np.sum(y[c + 1:] ** 2)
            pbeta, pscale = beta, scale
        c = s + ibk - 1
        at[c, c + 1:] *= pscale
        at[c, c] = pbeta
        t_rows(s, ibk)
        for sq in range(s + tb, s + ibk, tb):  # each sub-block joined to the ones before it
            wq = min(tb, s + ibk - sq)
            z_times_t(s, sq, wq)
            offdiag(s, sq, wq)
        e = s + ibk
        # the block apply and Z·T_b, one routine for both kinds of column
        vb, tbk = z_times_t(0, s, ibk)
        for c in range(e, n):
            at[c, s:] -= vb @ ((at[c, s:] @ vb) @ tbk)
        if e < kc:
            red[e & 1] = np.sum(at[e, e + 1:] ** 2)
        offdiag(0, s, ibk)
    t = np.zeros((n, n))
    for i in range(kc):
        for j in range(i, kc):
            t[i, j] = tp[tix(i, j, kc)]
    return at.T.copy(), t


@pytest.mark.parametrize("m,n,ib,chunk", [(72, 40, 32, 2048), (40, 40, 8, 5), (96, 72, 32, 7),
                                          (40, 30, 16, 1), (160, 136, 128, 64)], ids=str)
def test_small_model_matches_tileqr(m, n, ib, chunk):
    a = np.random.default_rng(m * n + ib).standard_normal((m, n))
    got = small_model(a, ib, chunk)
    want = tileqr_geqrt(a, ib)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-12


@pytest.mark.parametrize("m,n,ib", [(24, 40, 8), (7, 3, 8), (33, 17, 5)], ids=str)
def test_small_model_matches_plain_off_square(m, n, ib):
    """m < n (kcols = m: T zero right of column m, the apply on every
    column), a tile narrower than ib, an ib that leaves a block of 2."""
    a = np.random.default_rng(m + n).standard_normal((m, n))
    got = small_model(a, ib, 3)
    want = geqrt.geqrt_batched_plain(torch.tensor(a[None]), ib)
    for g, w in zip(got, want):
        assert rel(g, w[0].numpy()) <= 1e-12


# ---- the shared bytes ----

def test_small_smem_bytes_fit_one_cta():
    """Every (m, n) the route takes (4(mn + n² + m) ≤ 200 KiB) fits one CTA
    at any ib; 128² leaves room for two CTAs an SM (233,472 bytes, 1 KiB
    reserved a CTA)."""
    worst = 0
    for n in range(1, 230, 3):
        for m in range(1, 5700, 7):
            if not geqrt.takes_small(m, n):
                continue
            for ib in (1, 8, 32, 128, 4096):
                b = geqrt.small_smem_bytes(m, n, ib)
                worst = max(worst, b)
                assert b <= SMEM_LIMIT
    assert worst > 190 * 1024
    for ib, g in ((32, 496), (64, 2 * 496), (128, 4 * 496)):
        b = geqrt.small_smem_bytes(128, 128, ib)
        assert b == 4 * (128 * 132 + 128 * 129 // 2 + g + 6)
        assert 2 * (b + 1024) <= 233472
    for m in range(1, 300):
        ld = geqrt.small_tile_ld(m)
        assert ld >= max(m, 128) and ld % 4 == 0 and (ld // 4) % 2 == 1 and ld < max(m, 128) + 8

"""B9's blocked Cholesky on a thread-block cluster, on the CPU: its plan
and its order of operations.

- ``kernels/potrf.py:potrf_plan``: the cluster of a (b, n, n) stack on a
  card of ``sms`` SMs at the paths' shapes (the hr panel's gram, 1 × 256²:
  C = 4; the tsqr cholqr2 factor's, 1 × 512²: C = 8; ``cholqr2_batched`` at
  4096 × 128²: C = 1, a matrix a CTA) and the global-memory route where
  16 CTAs do not hold the matrix; its invariants over a sweep (the shared
  bytes within one CTA and equal to a recount of the kernel's layout, b·C
  within the card or C = 1, the plan follows the SM count) and its raises.
- A float64 model of ``csrc/potrf.cu``'s order (the bp-row blocks dealt
  cyclically to C CTAs, each stored from its block's first column on; a
  panel's row steps on its owner, then the SYRK on every later block from
  that block's first column on, each entry's terms in panel order; zeros
  left of each block), held against tileqr's ``potrf_batched`` in
  interpret mode to 1e-12 and bitwise equal to itself at every C: the
  kernel's entries take the same operations whatever C.
- On the CPU the wrapper runs the plain version whatever the plan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import cholqr as jcholqr
from tileqr_torch.kernels import _build, potrf
from tileqr_torch.kernels._build import CLUSTER_SIZES, SMEM_LIMIT

H100_SMS = 132

# (b, n) → (C, resident)
PLAN_CASES = {
    "hr-panel-gram": ((1, 256), (4, True)),
    "tsqr-cholqr2": ((1, 512), (8, True)),
    "qr-batched-cholqr2": ((4096, 128), (1, True)),
    "sharded-hr-768": ((1, 768), (16, True)),
    "one-tile": ((1, 16), (1, True)),
    "fits-16-ctas": ((1, 1024), (16, True)),
    "global-past-16-ctas": ((1, 2048), (16, False)),
    "global-stack": ((64, 512), (2, False)),
}


def layout_floats(n, bp, ctas, resident):
    """The kernel's shared floats, recounted: CTA q's blocks k ≡ q (mod C)
    of bp rows × round4(n − k·bp), the largest over q; a panel's copy on a
    cluster; a panel's pivot columns and reciprocal roots."""
    if not resident:
        return 16 * 16 + 16
    r4 = lambda x: (x + 3) // 4 * 4  # noqa: E731
    bp = min(bp, n)
    nblk = -(-n // bp)
    own = max(sum(bp * r4(n - k * bp) for k in range(q, nblk, ctas)) for q in range(ctas))
    return 16 * 16 + 16 + own + (bp * r4(n) if ctas > 1 else 0)


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=str)
def test_potrf_plan_at_the_paths_shapes(case):
    (b, n), (ctas, resident) = PLAN_CASES[case]
    plan = potrf.potrf_plan(b, n, H100_SMS)
    assert (plan.ctas, plan.resident) == (ctas, resident)
    assert plan.smem_bytes == 4 * layout_floats(n, 16, ctas, resident)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_potrf_plan_bytes_at_256():
    """The hr gram on 4 CTAs: CTA 0 holds blocks 0, 4, 8, 12 (16 rows × 256,
    192, 128, 64 columns), the panel copy 16 × 256, the pivot columns and
    their reciprocal roots 16 × 16 + 16."""
    plan = potrf.potrf_plan(1, 256, H100_SMS)
    assert plan == (4, 4 * (16 * (256 + 192 + 128 + 64) + 16 * 256 + 272), True, 256)
    assert -(-256 // plan.ctas) == potrf.POTRF_ROWS_PER_CTA


@pytest.mark.parametrize("n", [1, 3, 16, 40, 100, 128, 256, 300, 512, 700, 768, 1024, 1040])
def test_potrf_plan_invariants(n):
    for b in (1, 2, 3, 8, 33, 66, 67, 132, 133, 4096):
        plan = potrf.potrf_plan(b, n, H100_SMS)
        assert plan.ctas in CLUSTER_SIZES
        assert plan.ctas == 1 or b * plan.ctas <= H100_SMS
        assert 0 < plan.smem_bytes <= SMEM_LIMIT
        assert plan.smem_bytes == 4 * layout_floats(n, 16, plan.ctas, plan.resident)
        assert plan.resident == (4 * layout_floats(n, 16, plan.ctas, True) <= SMEM_LIMIT)
        # a panel row at two columns a thread where resident, eight on the global route
        assert plan.threads in (128, 256, 512)
        assert n <= (2 if plan.resident or plan.threads < 512 else 8) * plan.threads
    # one matrix: the fewest CTAs of at most 64 rows, 16 at most
    want = next((c for c in CLUSTER_SIZES if -(-n // c) <= potrf.POTRF_ROWS_PER_CTA), 16)
    assert potrf.potrf_plan(1, n, H100_SMS).ctas == want
    # the resident route ends where 16 CTAs stop holding the matrix
    assert potrf.potrf_plan(1, 1024, H100_SMS).resident
    assert not potrf.potrf_plan(1, 1040, H100_SMS).resident


def test_potrf_plan_follows_the_sm_count():
    """The same stack on a card of 64 SMs, and of 4."""
    assert potrf.potrf_plan(8, 512, 64).ctas == 8
    assert potrf.potrf_plan(16, 512, 64).ctas == 4
    assert potrf.potrf_plan(1, 512, 4).ctas == 4
    assert potrf.potrf_plan(3, 512, 4).ctas == 1


@pytest.mark.parametrize("args", [(0, 8, 132), (1, 0, 132), (1, 8, 0), (1, 8, 132, 0)],
                         ids=["no-batch", "no-n", "no-sms", "no-bp"])
def test_potrf_plan_raises(args):
    with pytest.raises(ValueError, match="potrf_plan"):
        potrf.potrf_plan(*args)


def blocked_model(g, ctas, bp=16):
    """csrc/potrf.cu's order in float64 on one (n, n) G: returns R."""
    n = g.shape[0]
    bp = min(bp, n)
    nblk = -(-n // bp)
    # each block's rows from its first column on, as its CTA stores them
    blk = {k: g[k * bp:min(n, (k + 1) * bp), k * bp:].copy() for k in range(nblk)}
    owner = {k: k % ctas for k in range(nblk)}
    for k in range(nblk):
        s = k * bp
        p = blk[k]  # (bpe, n - s): column l at p[:, l - s]
        bpe = p.shape[0]
        for jj in range(bpe):
            j = s + jj
            rinv = 1.0 / np.sqrt(max(p[jj, jj], 1e-30))
            col = p[:, jj].copy()  # the pivot column the owner posts
            for i in range(jj + 1, bpe):
                p[i, jj + 1:] = p[i, jj + 1:] - (col[i] * rinv) * (p[jj, jj + 1:] * rinv)
            p[jj, :] = np.where(np.arange(s, n) >= j, p[jj, :] * rinv, 0.0)
        for q in range(ctas):
            for kb in range(k + 1, nblk):
                if owner[kb] != q:
                    continue
                sb = kb * bp
                x = blk[kb]
                acc = np.zeros_like(x)
                for t in range(bpe):  # the chain from 0, panel order
                    acc = acc + np.outer(p[t, sb - s:sb - s + x.shape[0]], p[t, sb - s:])
                blk[kb] = x - acc
    r = np.zeros_like(g)
    for k in range(nblk):
        r[k * bp:k * bp + blk[k].shape[0], k * bp:] = blk[k]
    return r


@pytest.mark.parametrize("n", [16, 40, 64, 100])
def test_blocked_model_matches_tileqr(n):
    x = np.random.default_rng(n).standard_normal((2 * n, n))
    g = x.T @ x
    want = np.asarray(jcholqr.potrf_batched(jnp.asarray(g[None]), group=1, bp=16,
                                            interpret=True))[0]
    outs = [blocked_model(g, c) for c in CLUSTER_SIZES]
    for got in outs:
        assert np.array_equal(got, outs[0])  # the same operations on every C
    got = outs[0]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-12
    assert not np.tril(got, -1).any()
    assert np.linalg.norm(got.T @ got - g) / np.linalg.norm(g) <= 1e-12


def test_blocked_model_breakdown_is_not_an_exception():
    """A singular G: the clamp gives huge or non-finite rows, no raise."""
    with np.errstate(all="ignore"):
        r = blocked_model(np.zeros((40, 40)), 4)
    assert not np.isfinite(r).all() or np.abs(r).max() > 1e10 or not r.any()


def test_the_cpu_path_runs_the_plain_version():
    """A gram the card would factor on 4 CTAs runs the plain version on a
    CPU tensor: one plain call, no launch."""
    assert potrf.potrf_plan(1, 256, H100_SMS).ctas == 4
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 512, 256)))
    g = x.transpose(1, 2) @ x
    _build.reset_counts()
    got = potrf.potrf_batched(g)
    assert _build.PLAIN_CALLS["potrf_batched"] == 1 and not any(_build.LAUNCHES.values())
    assert torch.equal(got, potrf.potrf_batched_plain(g))

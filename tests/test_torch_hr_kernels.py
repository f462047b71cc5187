"""The hr path's kernels (plain versions, CPU) and CholeskyQR helpers against
the JAX package: B8 ``modified_lu``, B9 ``potrf_batched`` and B6
``panel_apply_carry`` against the Pallas kernels in interpret mode, and
the plain-torch helpers of ``drivers/cholqr.py`` / ``drivers/square_hr.py``
against their XLA counterparts, on the same numpy inputs.

Tolerances, each with its reason:
- float64: relative Frobenius ≤ 1e-12 (the same algebra; only the order of
  a few sums differs);
- float32 B8: ≤ 1e-5 (256 dependent rank-1 steps of fp32 rounding);
- float32 B6: max error ≤ 3e-6 of max|ref| (576-term fp32 contractions:
  |W| ~ √m, rounding ~ √m·eps, the JAX test's own bound). The JAX kernel
  refuses float64 (its Kahan scratch is float32), so B6 is held against
  the float64 formula C − Y(Tᵀ(YᵀC)) separately, at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import cholqr as jcholqr
from tileqr.drivers import square_hr as jsquare_hr
from tileqr.kernels.modlu import modified_lu as jmodified_lu
from tileqr.kernels.panel_apply import panel_apply_carry as jpanel_apply_carry
from tileqr_torch.drivers import cholqr, square_hr
from tileqr_torch.kernels import modlu, panel_apply, potrf

HI = jax.lax.Precision.HIGHEST


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("nb", [32, 64])
def test_modified_lu_matches_jax(dt, tol, nb):
    q, _ = np.linalg.qr(np.random.default_rng(nb).standard_normal((4 * nb, nb)))
    q_top = q[:nb].astype(dt)
    jlu, jd = jmodified_lu(jnp.asarray(q_top), interpret=True)
    lu, d = modlu.modified_lu(torch.tensor(q_top))
    assert rel(lu, jlu) <= tol
    assert np.array_equal(d.numpy(), np.asarray(jd))
    # the properties of tests/test_square_hr.py::test_modified_lu_identity
    lu64 = lu.double().numpy()
    l1 = np.tril(lu64, -1) + np.eye(nb)
    u = np.triu(lu64)
    resid = np.linalg.norm(l1 @ u - (q_top.astype(np.float64) - np.diag(d.double().numpy())))
    assert resid < (1e-12 if dt is np.float64 else 1e-5)
    assert np.abs(np.diag(u)).min() >= 0.9
    assert np.abs(l1).max() <= 1.0 + 1e-6
    assert set(np.unique(d.numpy())) <= {-1.0, 1.0}


def test_modified_lu_zero_pivot_takes_plus_one():
    """dj = +1 where the pivot is 0 (``piv0 > 0`` is false), as the JAX body."""
    lu, d = modlu.modified_lu(torch.zeros((8, 8), dtype=torch.float64))
    assert torch.equal(d, torch.ones(8, dtype=torch.float64))
    assert torch.equal(torch.diagonal(lu), -torch.ones(8, dtype=torch.float64))


@pytest.mark.parametrize("b,group,bp,n", [(4, 2, 8, 48), (4, 2, 16, 48), (1, 1, 16, 48),
                                          (1, 1, 8, 64)])
def test_potrf_batched_matches_jax(b, group, bp, n):
    x = np.random.default_rng(n + bp).standard_normal((b, 2 * n, n))
    g = np.einsum("bmi,bmj->bij", x, x)
    want = jcholqr.potrf_batched(jnp.asarray(g), group=group, bp=bp, interpret=True)
    got = potrf.potrf_batched(torch.tensor(g), bp=bp)
    assert rel(got, want) <= 1e-12
    assert not torch.tril(got, -1).any()  # zeros below the diagonal
    r = got.numpy()
    assert rel(np.einsum("bki,bkj->bij", r, r), g) <= 1e-12


def test_potrf_batched_breakdown_is_not_an_exception():
    """A singular gram: the clamped pivot gives a huge or NaN R, no raise."""
    g = torch.zeros((1, 8, 8), dtype=torch.float64)
    r = potrf.potrf_batched(g)
    assert not torch.isfinite(r).all() or r.abs().max() > 1e10 or not r.any()
    with pytest.raises(ValueError):
        potrf.potrf_batched(torch.zeros((3, 8, 6)))  # not square
    with pytest.raises(ValueError):
        potrf.potrf_batched(torch.zeros((3, 8, 8)), bp=0)


NB_B6, M_B6 = 32, 576


@pytest.fixture(scope="module")
def b6():
    """carry (M+nb)², float32, and the hr factors of its panels 0 and 1."""
    rng = np.random.default_rng(0)
    carry = rng.standard_normal((M_B6 + NB_B6, M_B6 + NB_B6)).astype(np.float32)
    out = {"carry": carry}
    for k in (0, 1):
        s = k * NB_B6
        y, tt, _ = jsquare_hr.hr_panel(jnp.asarray(carry[s:, s : s + NB_B6]), interpret=True)
        out[k] = (np.asarray(y), np.asarray(tt))
    return out


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_carry_matches_jax(b6, k, trans):
    carry = b6["carry"]
    y, tt = b6[k]
    want = np.asarray(jpanel_apply_carry(
        jnp.asarray(y), jnp.asarray(tt), jnp.asarray(carry), k=k, nb=NB_B6, trans=trans,
        precision="highest", interpret=True))
    c = torch.tensor(carry)
    out = panel_apply.panel_apply_carry(t(y), t(tt), c, k, NB_B6, trans=trans)
    assert out is c  # in place
    got = c.numpy()
    s = k * NB_B6
    assert np.array_equal(got[:s], carry[:s])  # rows above the window
    assert np.array_equal(got[:, : s + NB_B6], carry[:, : s + NB_B6])  # left of it
    assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()
    again = torch.tensor(carry)
    panel_apply.panel_apply_carry(t(y), t(tt), again, k, NB_B6, trans=trans)
    assert torch.equal(again, c)  # reruns are bitwise equal


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_carry_float64_formula(b6, k, trans):
    carry = b6["carry"].astype(np.float64)
    y, tt = (x.astype(np.float64) for x in b6[k])
    s = k * NB_B6
    win = carry[s:, s + NB_B6 :]
    tm = tt.T if trans else tt
    ref = win - y @ (tm @ (y.T @ win))
    c = torch.tensor(carry)
    panel_apply.panel_apply_carry(t(y), t(tt), c, k, NB_B6, trans=trans)
    assert rel(c.numpy()[s:, s + NB_B6 :], ref) <= 1e-12


def test_panel_apply_carry_kahan_accumulation():
    """The cross-block sum of phase 1 is Kahan-compensated (the JAX
    kernel's ``_kahan_add``). m = 17·nb rows make 17 row blocks of nb (17
    is prime, so ``_block`` finds no larger divisor); the block partials
    are 1.0 then sixteen of 2⁻²⁵, each below half an ulp of the running
    sum. A plain fp32 sum stays exactly 1.0; the compensated one carries
    them. Y's column 0 is all ones and T = e₀e₀ᵀ, so C's first window
    column loses W₀₀ = that sum, read exactly on rows where C was 0."""
    nb, blocks = 32, 17
    m = nb * blocks
    assert panel_apply._block(m, nb, 512) == nb
    parts = [np.float32(1.0)] + [np.float32(2.0 ** -25)] * (blocks - 1)
    acc = comp = np.float32(0.0)
    for p in parts:  # _kahan_add in float32
        yk = np.float32(p - comp)
        tk = np.float32(acc + yk)
        comp = np.float32(np.float32(tk - acc) - yk)
        acc = tk
    assert acc != np.float32(1.0) and abs(float(acc) - (1 + 16 * 2.0 ** -25)) <= 2.0 ** -23
    y = torch.zeros((m, nb))
    y[:, 0] = 1.0
    tt = torch.zeros((nb, nb))
    tt[0, 0] = 1.0
    carry = torch.zeros((m, m + nb))
    carry[torch.arange(blocks) * nb, nb] = torch.tensor(parts)  # one entry a block
    c = carry.clone()
    panel_apply.panel_apply_carry(y, tt, c, 0, nb, trans=True)
    assert float(-c[1, nb]) == float(acc)
    assert torch.equal(c[:, nb + 1 :], carry[:, nb + 1 :])  # the other columns: W = 0


def test_panel_apply_carry_rejects_bad_shapes():
    with pytest.raises(ValueError):  # window of 64 rows, Y of 32
        panel_apply.panel_apply_carry(torch.zeros(32, 32), torch.zeros(32, 32),
                                      torch.zeros(96, 96), 1, 32)
    with pytest.raises(ValueError):  # Y not nb wide
        panel_apply.panel_apply_carry(torch.zeros(96, 16), torch.zeros(32, 32),
                                      torch.zeros(96, 96), 0, 32)
    with pytest.raises(ValueError):  # window columns not a multiple of nb
        panel_apply.panel_apply_carry(torch.zeros(96, 32), torch.zeros(32, 32),
                                      torch.zeros(96, 80), 0, 32)


def test_bdot_pair_rows_matches_jax():
    """m ≥ 1024 so the pairwise tree runs, with a ragged tail block."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1100, 8))
    y = rng.standard_normal((2, 1100, 6))
    want = jcholqr.bdot_pair_rows(jnp.asarray(x), jnp.asarray(y), HI, jnp.float64)
    got = cholqr.bdot_pair_rows(torch.tensor(x), torch.tensor(y))
    assert got.shape == (2, 8, 6) and rel(got, want) <= 1e-12
    # the cap on the partials' bytes shortens the tree the same way
    want = jcholqr.bdot_pair_rows(jnp.asarray(x), jnp.asarray(y), HI, jnp.float64,
                                  blk=64, cap_bytes=2 * 8 * 6 * 8 * 3)
    got = cholqr.bdot_pair_rows(torch.tensor(x), torch.tensor(y), blk=64,
                                cap_bytes=2 * 8 * 6 * 8 * 3)
    assert rel(got, want) <= 1e-12


def test_triu_inv_doubling_and_up_half_match_jax():
    rng = np.random.default_rng(2)
    r = np.triu(rng.standard_normal((3, 40, 40))) + 8 * np.eye(40)
    want = jcholqr._triu_inv_doubling(jnp.asarray(r), HI)
    got = cholqr._triu_inv_doubling(torch.tensor(r))
    assert rel(got, want) <= 1e-12
    assert rel(got.numpy() @ r, np.broadcast_to(np.eye(40), r.shape)) <= 1e-12
    e = rng.standard_normal((2, 16, 16))
    assert np.array_equal(cholqr._up_half(torch.tensor(e)).numpy(),
                          np.asarray(jcholqr._up_half(jnp.asarray(e))))


@pytest.mark.parametrize("m", [4104, 4096, 24])
def test_w_splitk_matches_jax(m):
    rng = np.random.default_rng(m)
    y = rng.standard_normal((m, 16))
    c = rng.standard_normal((m, 40))
    want = jsquare_hr._w_splitk(jnp.asarray(y), jnp.asarray(c), HI, jnp.float64)
    got = square_hr._w_splitk(torch.tensor(y), torch.tensor(c))
    assert rel(got, want) <= 1e-12


def _yt(rng, m, nb, dt):
    """Compact-WY-shaped factors (unit lower trapezoidal Y, upper T)."""
    y = rng.standard_normal((m, nb)) / np.sqrt(m)
    y[:nb] = np.tril(y[:nb], -1) + np.eye(nb)
    tt = np.triu(rng.standard_normal((nb, nb))) / nb
    return y.astype(dt), tt.astype(dt)


@pytest.mark.parametrize("route,m,cols,dt", [
    ("pairwise", 2048, 8, np.float64),
    ("plain", 512, 40, np.float64),
    ("plain-wide", 2048, 1056, np.float64),
    ("splitk", 4096, 1064, np.float32),
    ("B7", 4096, 1056, np.float32),
])
@pytest.mark.parametrize("trans", [True, False])
def test_apply_block_t_routes_match_jax(route, m, cols, dt, trans):
    """Each W route of _apply_block_t: pairwise (m ≥ 2048, ≤ 1024 columns),
    one product, split-K (m ≥ 4096, float32 only, a target that is not
    nb-aligned) and, for an nb-aligned float32 target wider than 1024
    columns, B7 with its Kahan sums in place of the reference's split-K.
    The float32 routes are held at the float32 level, max error ≤ 1e-6 of
    max|ref| as tests/test_square_hr.py does."""
    rng = np.random.default_rng(m + cols)
    y, tt = _yt(rng, m, 32, dt)
    c = rng.standard_normal((m, cols)).astype(dt)
    want = np.asarray(jsquare_hr._apply_block_t(
        jnp.asarray(y), jnp.asarray(tt), jnp.asarray(c), HI, jnp.dtype(dt), trans=trans))
    got = square_hr._apply_block_t(t(y), t(tt), t(c), trans).numpy()
    if dt is np.float64:
        assert rel(got, want) <= 1e-12
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

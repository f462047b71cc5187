"""tileqr_torch's tall-skinny path against tileqr's (JAX on the CPU, Pallas
in interpret mode), on the same numpy inputs: the leaf and tree plans,
``tsqr_factor`` with every tree level, ``tsqr_apply_q`` both ways,
``tsqr_form_q``, ``tileqr_torch.tsqr`` in every mode and strategy, the
cholqr2 guard, interop of ``TSQRFactors`` and the entry's ValueErrors.

Tolerances, relative Frobenius difference per output:
- float64 ≤ 1e-12 where both sides run the same algebra (GEQRT column
  loops, compact-WY products; only the summation order differs), and
  ≤ 1e-10 where a longer chain of products feeds the compared value (the
  API's Q and R through padding, the chain's square driver, CholeskyQR2's
  inverse and correction rounds);
- float32 ≤ 1e-5, the relerr level: the two packages round differently.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr.drivers import tsqr as jtsqr
from tileqr_torch.drivers import tsqr
from tileqr_torch.interop import tsqr_factors_from_numpy, tsqr_factors_to_numpy

TOL = {np.float64: 1e-12, np.float32: 1e-5}
TOL_API = {np.float64: 1e-10, np.float32: 1e-5}
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}
TDT = {np.float64: torch.float64, np.float32: torch.float32}
DTS = [np.float64, np.float32]
DT_IDS = ["f64", "f32"]


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def cfgs(dt, **kw):
    return (tileqr.QRConfig(dtype=JDT[dt], **kw),
            tileqr_torch.QRConfig(dtype=TDT[dt], **kw))


@pytest.mark.parametrize("m,n", [(1048576, 512), (1024, 64), (4608, 1536), (10**6, 192),
                                 (10**7, 8), (262144, 8), (288, 12), (100, 7)])
def test_auto_leaf_rows_matches_tileqr(m, n):
    assert tsqr.auto_leaf_rows(m, n) == jtsqr.auto_leaf_rows(m, n)
    assert tsqr.auto_leaf_rows(1048576, 512) == 2048


@pytest.mark.parametrize("p,n,lr,arity", [(512, 512, 2048, 8), (11, 32, 96, 8), (7, 32, 96, 2),
                                          (1, 16, 64, 8), (130, 8, 64, 16)])
def test_tree_plan_matches_tileqr(p, n, lr, arity):
    assert tuple(tsqr._tree_plan(p, n, lr, arity)) == tuple(jtsqr._tree_plan(p, n, lr, arity))


def check_factors(f, jf, dt):
    """Every array of a TSQRFactors against the JAX record's."""
    assert (f.leaf_rows, f.shape, f.plan) == (jf.leaf_rows, jf.shape, jf.plan)
    assert len(f.levels) == len(jf.levels)
    pairs = [(f.packed_leaves, jf.packed_leaves), (f.t_leaves, jf.t_leaves), (f.r, jf.r)]
    for (pk, tl, cnt, a_l), (jpk, jtl, jcnt, ja_l) in zip(f.levels, jf.levels):
        assert (cnt, a_l) == (jcnt, ja_l)
        pairs += [(pk, jpk), (tl, jtl)]
    for g, w in pairs:
        assert tuple(g.shape) == tuple(w.shape)
        assert rel(g, w) <= TOL[dt]


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("p,arity", [(2, 2), (7, 2), (8, 4), (11, 8), (16, 8)])
def test_tsqr_factor_levels_match_tileqr(p, arity, dt):
    """The (p, arity) cases of ``tests/test_tsqr_tree.py``: multi-level
    trees, remainders, and the arity cap leaf_rows // n = 3."""
    n, lr = 32, 96
    a = np.random.default_rng(p).standard_normal((p * lr, n)).astype(dt)
    jf = jtsqr.tsqr_factor(jnp.asarray(a), nb=128, interpret=True, leaf_rows=lr, arity=arity)
    f = tsqr.tsqr_factor(torch.tensor(a), 128, leaf_rows=lr, arity=arity)
    check_factors(f, jf, dt)


def test_tsqr_factor_non8_n_matches_tileqr():
    """n = 12: combine stacks of a·n = 48 rows, not a multiple of 8."""
    a = np.random.default_rng(12).standard_normal((288, 12))
    jf = jtsqr.tsqr_factor(jnp.asarray(a), nb=16, leaf_rows=48, interpret=True)
    f = tsqr.tsqr_factor(torch.tensor(a), 16, leaf_rows=48)
    check_factors(f, jf, np.float64)


def test_tsqr_factor_tall_n8_leaves_match_tileqr():
    """n = 8: the auto leaf is 131072 rows, a 4 MiB leaf far past the
    kernel's shared-memory budget (the global-workspace variant on the
    card; its reflector does not fit shared memory either)."""
    m, n = 2 * 131072, 8
    assert tsqr.auto_leaf_rows(m, n) == 131072
    a = np.random.default_rng(8).standard_normal((m, n))
    jf = jtsqr.tsqr_factor(jnp.asarray(a), nb=8, interpret=True)
    f = tsqr.tsqr_factor(torch.tensor(a), 8)
    assert f.leaf_rows == 131072 and len(f.levels) == 1
    check_factors(f, jf, np.float64)


APPLY_CASES = [(5, 32, 64, 4), (6, 24, 72, 3)]


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("p,n,lr,arity", APPLY_CASES)
def test_apply_q_and_form_q_match_tileqr(p, n, lr, arity, dt):
    """Qᵀ C and Q C on C with fewer rows than the factored M (the padded
    rows act as the identity), and the reduced Q."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((p * lr, n)).astype(dt)
    c = rng.standard_normal((p * lr - 5, 7)).astype(dt)
    jf = jtsqr.tsqr_factor(jnp.asarray(a), nb=128, interpret=True, leaf_rows=lr, arity=arity)
    f = tsqr.tsqr_factor(torch.tensor(a), 128, leaf_rows=lr, arity=arity)
    for trans in (True, False):
        got = tsqr.tsqr_apply_q(f, torch.tensor(c), trans=trans)
        want = jtsqr.tsqr_apply_q(jf, jnp.asarray(c), trans=trans)
        assert tuple(got.shape) == c.shape and rel(got, want) <= TOL[dt]
    assert rel(tsqr.tsqr_form_q(f), jtsqr.tsqr_form_q(jf)) <= TOL[dt]
    with pytest.raises(ValueError):
        tsqr.tsqr_apply_q(f, torch.zeros((p * lr + 1, 2), dtype=TDT[dt]))


# (shape, nb): a single leaf, and two leaves of auto_leaf_rows = 8192 with
# one combine
API_SHAPES = {"one-leaf": ((1000, 48), 64), "two-leaves": ((16384, 128), 128)}
# port strategy → the JAX strategy named for the same route on the CPU
ROUTES = [("tree", "r"), ("tree", "reduced"), ("tree", "factor"), ("chain", "r"),
          ("chain", "reduced"), ("cholqr2", "r"), ("cholqr2", "reduced"),
          ("cholqr2", "factor"), ("auto", "r"), ("auto", "reduced"), ("auto", "factor")]
JAX_ROUTE = {("auto", "r"): "tree", ("auto", "reduced"): "tree", ("auto", "factor"): "cholqr2"}


@pytest.fixture(scope="module")
def api_inputs():
    return {k: np.random.default_rng(shape[0]).standard_normal(shape)
            for k, (shape, _) in API_SHAPES.items()}


def compare_api(got, want, tol):
    if isinstance(got, tuple) and not hasattr(got, "_fields"):
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(np.shape(w)) and rel(g, w) <= tol
    elif isinstance(got, tileqr_torch.TSQRFactors):
        check_factors(got, want, np.float64)
    elif isinstance(got, tileqr_torch.HRFactors):
        assert type(want).__name__ == "HRFactors"
        assert (got.nb, got.shape) == (want.nb, want.shape)
        assert rel(got.r, want.r) <= tol
        assert float(got.health) <= 0.05 and float(want.health) <= 0.05  # hr_guard_tau
        for (y, t), (jy, jt) in zip(got.panels, want.panels):
            assert rel(y, jy) <= tol and rel(t, jt) <= tol
    else:
        assert tuple(got.shape) == tuple(np.shape(want)) and rel(got, want) <= tol


@pytest.mark.parametrize("strategy,mode", ROUTES, ids=[f"{s}-{m}" for s, m in ROUTES])
def test_tsqr_api_matches_tileqr(api_inputs, strategy, mode):
    """float64. The two-leaf shape (a tree level) only where the tree runs:
    the chain's square driver is trace-unrolled on the JAX side, and
    CholeskyQR2 has no leaves."""
    tree = strategy == "tree" or (strategy, mode) in (("auto", "r"), ("auto", "reduced"))
    for key, (shape, nb) in API_SHAPES.items():
        if key != "one-leaf" and not tree:
            continue
        a = api_inputs[key]
        jcfg, tcfg = cfgs(np.float64, nb=nb)
        want = tileqr.tsqr(a, mode, jcfg, strategy=JAX_ROUTE.get((strategy, mode), strategy))
        got = tileqr_torch.tsqr(a, mode, tcfg, strategy=strategy, device="cpu")
        compare_api(got, want, TOL_API[np.float64])


@pytest.mark.parametrize("strategy", ["tree", "cholqr2"])
def test_tsqr_api_float32_matches_tileqr(api_inputs, strategy):
    a = api_inputs["one-leaf"].astype(np.float32)
    jcfg, tcfg = cfgs(np.float32, nb=64)
    q, r = tileqr_torch.tsqr(a, "reduced", tcfg, strategy=strategy, device="cpu")
    jq, jr = tileqr.tsqr(a, "reduced", jcfg, strategy=strategy)
    assert rel(q, jq) <= TOL[np.float32] and rel(r, jr) <= TOL[np.float32]


def test_tsqr_cholqr2_guard_falls_back_to_the_tree():
    """Near-duplicate columns break the CholeskyQR contract: the guard warns
    and the tree's result comes back, in every mode, as in tileqr (which
    warns too). R of such an A is ill-conditioned, so the two packages'
    fallbacks are held to the residual, the port's to its own tree."""
    a = np.random.default_rng(3).standard_normal((512, 64)).astype(np.float32)
    a[:, 1] = a[:, 0] * (1 + 1e-7)
    jcfg, tcfg = cfgs(np.float32, nb=64)
    for mode in ("r", "reduced"):
        with pytest.warns(UserWarning, match="hr guard"):
            got = tileqr_torch.tsqr(a, mode, tcfg, strategy="cholqr2", device="cpu")
        with pytest.warns(UserWarning, match="hr guard"):
            tileqr.tsqr(a, mode, jcfg, strategy="cholqr2")
        tree = tileqr_torch.tsqr(a, mode, tcfg, strategy="tree", device="cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, tree)) if mode == "reduced" \
            else torch.equal(got, tree)
    q, r = (x.double().numpy() for x in got)
    assert np.linalg.norm(q @ r - a) / np.linalg.norm(a) < 1e-5
    assert np.linalg.norm(q.T @ q - np.eye(64)) < 1e-4
    for strategy in ("cholqr2", "auto"):
        with pytest.warns(UserWarning, match="hr guard"):
            f = tileqr_torch.tsqr(a, "factor", tcfg, strategy=strategy, device="cpu")
        assert isinstance(f, tileqr_torch.TSQRFactors)
    # guard "warn" keeps the CholeskyQR result; "off" runs no check, and
    # auto+factor then takes the tree
    warn = tileqr_torch.QRConfig(nb=64, hr_guard="warn")
    with pytest.warns(UserWarning, match="keeping the CholeskyQR"):
        assert isinstance(tileqr_torch.tsqr(a, "factor", warn, "cholqr2", device="cpu"),
                          tileqr_torch.HRFactors)
    off = tileqr_torch.QRConfig(nb=64, hr_guard="off")
    assert isinstance(tileqr_torch.tsqr(a, "factor", off, device="cpu"), tileqr_torch.TSQRFactors)


def test_apply_q_and_orgqr_take_tsqr_factors(api_inputs):
    """The port routes TSQRFactors to tsqr_apply_q / tsqr_form_q. tileqr's
    own apply_q/orgqr raise AttributeError on them (they read f.packed), a
    fault of the reference that the port does not copy."""
    a = api_inputs["two-leaves"]
    jcfg, tcfg = cfgs(np.float64, nb=128)
    f = tileqr_torch.tsqr(a, "factor", tcfg, strategy="tree", device="cpu")
    jf = tileqr.tsqr(a, "factor", jcfg, strategy="tree")
    for trans in (True, False):
        got = tileqr_torch.apply_q(f, a, trans=trans)
        assert rel(got, jtsqr.tsqr_apply_q(jf, jnp.asarray(a), trans=trans)) <= TOL[np.float64]
    qta = tileqr_torch.apply_q(f, a, trans=True).numpy()
    assert np.linalg.norm(qta[:128] - f.r.numpy()) / np.linalg.norm(a) <= 1e-13
    q = tileqr_torch.orgqr(f)
    assert tuple(q.shape) == f.shape and rel(q, jtsqr.tsqr_form_q(jf)) <= TOL[np.float64]
    assert torch.equal(tileqr_torch.orgqr(f, 128), q)
    with pytest.raises(ValueError, match="reduced Q only"):
        tileqr_torch.orgqr(f, 64)
    with pytest.raises(AttributeError):
        tileqr.apply_q(jf, a, trans=True)


def test_tsqr_factors_interop_both_ways(api_inputs):
    """JAX's TSQRFactors drive the port's apply_q, and the port's rebuild
    the JAX record (levels as (pk, tl, count, arity), the plan as tuples)."""
    a = api_inputs["two-leaves"]
    jcfg, tcfg = cfgs(np.float64, nb=128)
    jf = tileqr.tsqr(a, "factor", jcfg, strategy="tree")
    c = np.random.default_rng(9).standard_normal((a.shape[0], 3))
    want = np.asarray(jtsqr.tsqr_apply_q(jf, jnp.asarray(c), trans=True))
    f = tsqr_factors_from_numpy(jf)
    assert rel(tileqr_torch.apply_q(f, c, trans=True), want) <= TOL[np.float64]
    back = tsqr_factors_to_numpy(tileqr_torch.tsqr(a, "factor", tcfg, strategy="tree",
                                                    device="cpu"))
    jback = jtsqr.TSQRFactors(**back)
    assert jback.plan == jf.plan and [lv[2:] for lv in jback.levels] == [lv[2:] for lv in jf.levels]
    assert rel(jtsqr.tsqr_apply_q(jback, jnp.asarray(c), trans=True), want) <= TOL[np.float64]


@pytest.mark.parametrize("bad,kw,match", [
    (np.ones(16), {}, "2-D"),
    (np.ones((2, 16, 16)), {}, "qr_batched"),
    (np.ones((16, 0)), {}, "zero-size"),
    (np.ones((8, 16)), {}, "M >= n"),
    (np.ones((64, 8)), {"strategy": "x"}, "strategy"),
    (np.ones((64, 8)), {"mode": "x"}, "mode"),
    (np.ones((64, 8)), {"strategy": "chain", "mode": "factor"}, "factor"),
    (np.ones((512, 300)), {"strategy": "tree"}, "nb"),
])
def test_tsqr_rejects(bad, kw, match):
    with pytest.raises(ValueError, match=match):
        tileqr_torch.tsqr(bad, config=tileqr_torch.QRConfig(dtype=torch.float64),
                          device="cpu", **kw)

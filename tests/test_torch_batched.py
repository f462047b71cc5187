"""tileqr_torch's batched GEQRT and batched QR against tileqr's (JAX on the
CPU, Pallas in interpret mode), on the same numpy inputs: the plain
batched GEQRT against the JAX kernels it stands for (``geqrt_batched`` at
ib = 128, ``geqrt_batched_grouped`` at ib = 32, the single-tile
``geqrt``), ``cholqr2_batched``, ``tileqr_torch.qr_batched`` on both
routes with its guard, and the entry's ValueErrors.

Tolerances, relative Frobenius difference per output:
- float64 ≤ 1e-12 where both sides run the same algebra (the GEQRT column
  loop, CholeskyQR2's products; only the summation order differs);
- float64 ≤ 1e-10 against the JAX vec route (``geqrt_batched_vec``, odd
  B), which builds T column by column in another order than the port's
  doubling recurrence;
- float32 ≤ 1e-5, the relerr level: the two packages round differently.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr.drivers import batched as jbatched
from tileqr.drivers import cholqr as jcholqr
from tileqr.kernels import geqrt as jgeqrt
from tileqr_torch.drivers import cholqr
from tileqr_torch.kernels import _build, geqrt

TOL = {np.float64: 1e-12, np.float32: 1e-5}
TOL_VEC = 1e-10
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


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("route", ["per-matrix-ib128", "grouped-ib32"])
def test_geqrt_batched_plain_matches_jax(route, b, dt):
    """B16 (one matrix per grid step, ib = 128) and B11 (group = the
    largest power of two dividing B, ib = 32); (72, 40) gives the grouped
    route two ib blocks."""
    a = np.random.default_rng(b).standard_normal((b, 72, 40)).astype(dt)
    if route == "per-matrix-ib128":
        ib, want = 128, jbatched.geqrt_batched(jnp.asarray(a), interpret=True)
    else:
        ib, want = 32, jbatched.geqrt_batched_grouped(
            jnp.asarray(a), group=jbatched.select_group(b), ib=32, interpret=True)
    _build.reset_counts()
    got = geqrt.geqrt_batched(torch.tensor(a), ib)
    assert _build.PLAIN_CALLS["geqrt_batched"] == 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and rel(g, w) <= TOL[dt]


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("shape", [(128, 64), (192, 128), (32, 48)])
def test_geqrt_single_tile_matches_jax(shape, dt):
    """B1s, the B = 1 case; (32, 48) is wide, kcols = min(m, n) = 32."""
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dt)
    want = jgeqrt.geqrt(jnp.asarray(a), interpret=True)
    got = geqrt.geqrt(torch.tensor(a))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and rel(g, w) <= TOL[dt]
    packed, t = got
    if shape[0] >= shape[1]:
        # QᵀA = R through the reflectors: the factors are a QR of A
        v = torch.tril(packed, -1) + torch.eye(*shape, dtype=packed.dtype)
        at = torch.tensor(a)
        qta = at - v @ (t.T @ (v.T @ at))
        assert rel(qta[: shape[1]], torch.triu(packed[: shape[1]])) <= 10 * TOL[dt]


def test_geqrt_rejects_bad_input():
    with pytest.raises(ValueError):
        geqrt.geqrt_batched(torch.zeros((4, 4)), 32)  # not a stack
    with pytest.raises(ValueError):
        geqrt.geqrt_batched(torch.zeros((0, 4, 4)), 32)
    with pytest.raises(ValueError):
        geqrt.geqrt_batched(torch.zeros((2, 4, 4)), 0)
    with pytest.raises(ValueError):
        geqrt.geqrt(torch.zeros((2, 4, 4)))


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("shape", [(4, 96, 32), (4, 48, 32)],
                         ids=["tall-explicit-inverse", "folded-doubling"])
def test_cholqr2_batched_matches_jax(shape, dt):
    """Both branches of Q₁ = A·R₁⁻¹ (m > 2n forms S₁; otherwise the
    doubling factors are folded into A), modes r and reduced, and the
    health scalar."""
    a = np.random.default_rng(shape[1]).standard_normal(shape).astype(dt)
    q, r, h = cholqr.cholqr2_batched(torch.tensor(a), stats=True)
    jq, jr, jh = jcholqr.cholqr2_batched(jnp.asarray(a), group=1, interpret=True, stats=True)
    assert rel(q, jq) <= TOL[dt] and rel(r, jr) <= TOL[dt]
    assert 0 < float(h) < 1e-3 and 0 < float(jh) < 1e-3
    assert torch.equal(cholqr.cholqr2_batched(torch.tensor(a), mode="r"), r)


# (B, m, n): B = 16 takes the JAX grouped route (group 16), B = 3 its vec
# route; (45, 20) pads to (48, 24)
BATCH_CASES = [(16, 45, 20), (3, 45, 20)]


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
@pytest.mark.parametrize("case", BATCH_CASES, ids=["B16-grouped", "B3-vec"])
def test_qr_batched_hh_matches_tileqr(case, dt):
    b = case[0]
    a = np.random.default_rng(b).standard_normal(case).astype(dt)
    jcfg, tcfg = cfgs(dt, nb=32)
    tol = TOL[dt] if (dt is np.float32 or b == 16) else TOL_VEC
    q, r = tileqr_torch.qr_batched(a, config=tcfg, device="cpu")
    jq, jr = tileqr.qr_batched(a, config=jcfg)
    assert tuple(q.shape) == jq.shape and tuple(r.shape) == jr.shape
    assert rel(q, jq) <= tol and rel(r, jr) <= tol
    r_only = tileqr_torch.qr_batched(a, "r", tcfg, device="cpu")
    assert torch.equal(r_only, r)


@pytest.mark.parametrize("dt", DTS, ids=DT_IDS)
def test_qr_batched_cholqr2_matches_tileqr(dt):
    a = np.random.default_rng(6).standard_normal((6, 45, 20)).astype(dt)
    jcfg, tcfg = cfgs(dt, batched_method="cholqr2")
    q, r = tileqr_torch.qr_batched(a, config=tcfg, device="cpu")
    jq, jr = tileqr.qr_batched(a, config=jcfg)
    assert tuple(q.shape) == jq.shape and tuple(r.shape) == jr.shape
    assert rel(q, jq) <= TOL[dt] and rel(r, jr) <= TOL[dt]
    assert rel(tileqr_torch.qr_batched(a, "r", tcfg, device="cpu"), jr) <= TOL[dt]


def test_qr_batched_cholqr2_guard_falls_back_to_hh():
    """One breakdown member sends the whole batch to the Householder route
    with a warning, as in tileqr: the result is the hh route's, bitwise."""
    a = np.random.default_rng(8).standard_normal((8, 64, 32)).astype(np.float32)
    a[3, :, 1] = a[3, :, 0] * (1 + 1e-7)
    jcfg, tcfg = cfgs(np.float32, nb=32, batched_method="cholqr2")
    _build.reset_counts()
    with pytest.warns(UserWarning, match="hr guard"):
        q, r = tileqr_torch.qr_batched(a, config=tcfg, device="cpu")
    assert _build.PLAIN_CALLS["potrf_batched"] == 1 and _build.PLAIN_CALLS["geqrt_batched"] == 1
    hq, hr = tileqr_torch.qr_batched(a, config=tileqr_torch.QRConfig(nb=32), device="cpu")
    assert torch.equal(q, hq) and torch.equal(r, hr)
    with pytest.warns(UserWarning, match="hr guard"):
        tileqr.qr_batched(a, config=jcfg)
    q64, r64 = q.double().numpy(), r.double().numpy()
    res = np.linalg.norm(q64 @ r64 - a, axis=(1, 2)) / np.linalg.norm(a, axis=(1, 2))
    assert res.max() < 1e-5


@pytest.mark.parametrize("bad,kw,match", [
    (np.ones((16, 16)), {}, r"\(B, m, n\)"),
    (np.ones((2, 0, 4)), {}, "zero-size"),
    (np.ones((2, 4, 8)), {}, "m >= n"),
    (np.ones((2, 8, 4)), {"config": tileqr_torch.QRConfig(batched_method="x")},
     "batched_method"),
    (np.ones((2, 8, 4)), {"mode": "complete"}, "mode"),
])
def test_qr_batched_rejects(bad, kw, match):
    with pytest.raises(ValueError, match=match):
        tileqr_torch.qr_batched(bad, device="cpu", **kw)


def test_numpy_input_goes_to_the_card(monkeypatch):
    """With no device=, a numpy stack goes to the card: without CUDA it
    raises before any plain version runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tileqr_torch.qr_batched(np.ones((2, 8, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tileqr_torch.tsqr(np.ones((64, 8)))
    assert not any(_build.PLAIN_CALLS.values())

"""tileqr_torch's hr driver (``drivers/square_hr.py``) on the CPU against
the JAX driver (``tileqr/drivers/square_hr.py``, Pallas kernels in
interpret mode) on the same numpy inputs.

Tolerances, each with its reason:
- ``hr_panel`` float64: Y, T, R ≤ 1e-11 relative Frobenius (the same
  algebra in the same order; the gram squares the panel's condition
  number, so the rounding differences of its sums grow by about cond);
  health (a rounding-level max, ~1e-15) ≤ 1e-11 absolute;
- ``qr_hr`` float64 against the JAX static driver (XLA trailing update;
  the JAX kernel route refuses float64): R and every (Y_k, T_k) ≤ 1e-10
  relative (CholeskyQR's gram per panel, compounded over the panels);
- ``apply_q_hr`` / ``orgqr_hr`` on the SAME factors: ≤ 1e-12 (matmuls
  only, the same routes);
- float32 against ``qr_hr_chunked`` (the JAX kernel route, as the port's
  driver is): ≤ 1e-4 max abs, the bound of tests/test_square_hr.py:270.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import square_hr as jhr
from tileqr_torch.drivers import square_hr

NB = 32


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


@pytest.mark.parametrize("m,nb", [(160, 32), (96, 32), (256, 64)])
def test_hr_panel_matches_jax_fused(m, nb):
    p = np.random.default_rng(m + nb).standard_normal((m, nb))
    jy, jt, jr, jh = jhr.hr_panel_fused(jnp.asarray(p), True, stats=True)
    y, t, r, h = square_hr.hr_panel(torch.tensor(p), stats=True)
    assert rel(y, jy) <= 1e-11 and rel(t, jt) <= 1e-11 and rel(r, jr) <= 1e-11
    assert abs(float(h) - float(jh)) <= 1e-11
    # the reflector: I − Y·T·Yᵀ is orthogonal and maps P onto [R; 0]
    y64, t64 = y.numpy(), t.numpy()
    qq = np.eye(m) - y64 @ t64 @ y64.T
    assert np.linalg.norm(qq.T @ qq - np.eye(m)) <= 1e-12
    assert rel(qq[:, :nb] @ r.numpy(), p) <= 1e-12


def test_hr_panel_health_is_nan_propagating():
    """A NaN in the panel reaches the health scalar (the guard's signal)."""
    p = np.random.default_rng(1).standard_normal((96, 32))
    p[5, 3] = np.nan
    *_, h = square_hr.hr_panel(torch.tensor(p), stats=True)
    assert math.isnan(float(h))


def test_hr_panel_parts_are_what_the_kernels_take():
    """The gram and Q_top handed to B9 and B8, and the compact-WY form of
    (Y, T): T's diagonal is LAPACK's tau, so torch.ormqr applies the same
    Qᵀ (the library yardstick of B6). Float64, ≤ 1e-13 (one product)."""
    p = torch.tensor(np.random.default_rng(5).standard_normal((256, 32)))
    c = torch.tensor(np.random.default_rng(6).standard_normal((256, 40)))
    parts = square_hr.hr_panel_parts(p)
    assert rel(parts["gram"][0], p.T @ p) <= 1e-13
    lu, d = square_hr.modified_lu(parts["q_top"])
    l1 = np.tril(lu.numpy(), -1) + np.eye(32)
    assert rel(parts["y"][:32], l1) == 0.0 and torch.equal(parts["y"], square_hr.hr_panel(p)[0])
    y, t = parts["y"], parts["t"]
    want = c - y @ (t.T @ (y.T @ c))
    got = torch.ormqr(y, torch.diagonal(t).contiguous(), c, left=True, transpose=True)
    assert rel(got, want) <= 1e-13


def test_hr_steps_defects_reduce_to_the_health():
    """``hr_steps`` yields each panel's defect; ``qr_hr``'s health is their
    NaN-propagating max and its factors are the steps' (bitwise)."""
    a = np.random.default_rng(8).standard_normal((160, 96))
    ap, _ = square_hr.pad_for_hr(torch.tensor(a), NB)
    steps = list(square_hr.hr_steps(ap.clone(), NB, stats=True))
    r, panels, h = square_hr.qr_hr(ap.clone(), NB, stats=True)
    assert len(steps) == len(panels) == 3
    assert float(h) == max(float(d) for _, _, d in steps)
    assert all(torch.equal(y, y2) and torch.equal(t, t2)
               for (y, t, _), (y2, t2) in zip(steps, panels))
    assert all(d is None for _, _, d in square_hr.hr_steps(ap.clone(), NB))


# name: (shape, dtype); padded by the port's pad_for_hr, fed to both drivers
DRIVER_CASES = {"square-128": ((128, 128), np.float64), "unaligned-100x70": ((100, 70), np.float64),
                "tall-160x96": ((160, 96), np.float64)}


@pytest.fixture(scope="module")
def driven():
    out = {}
    for name, (shape, dt) in DRIVER_CASES.items():
        a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dt)
        ap, _ = square_hr.pad_for_hr(torch.tensor(a), NB)
        ap = ap.numpy()
        c = np.random.default_rng(7).standard_normal((ap.shape[0], 5)).astype(dt)
        jr, jpanels, jh = jhr.qr_hr(jnp.asarray(ap), NB, interpret=True, stats=True)
        out[name] = {
            "ap": ap, "c": c, "r": np.asarray(jr), "h": float(jh),
            "panels": [(np.asarray(y), np.asarray(t)) for y, t in jpanels],
            "qc": np.asarray(jhr.apply_q_hr(jpanels, jnp.asarray(c), NB, trans=False,
                                            interpret=True)),
            "qtc": np.asarray(jhr.apply_q_hr(jpanels, jnp.asarray(c), NB, trans=True,
                                             interpret=True)),
            "q": np.asarray(jhr.orgqr_hr(jpanels, ap.shape[0], NB, min(ap.shape),
                                         interpret=True)),
        }
    return out


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_qr_hr_matches_jax_static(driven, case):
    d = driven[case]
    ap = torch.tensor(d["ap"])
    r, panels, h = square_hr.qr_hr(ap, NB, stats=True)
    assert tuple(r.shape) == d["r"].shape and len(panels) == len(d["panels"])
    assert rel(r, d["r"]) <= 1e-10
    for (y, t), (jy, jt) in zip(panels, d["panels"]):
        assert tuple(y.shape) == jy.shape and rel(y, jy) <= 1e-10 and rel(t, jt) <= 1e-10
    assert abs(float(h) - d["h"]) <= 1e-11
    # in place: the R rows are left in ap; a rerun is bitwise equal
    assert torch.equal(torch.triu(ap[: r.shape[0]]), r)
    r2, panels2, _ = square_hr.qr_hr(torch.tensor(d["ap"]), NB, stats=True)
    assert torch.equal(r, r2) and all(torch.equal(x, x2) for p, p2 in zip(panels, panels2)
                                      for x, x2 in zip(p, p2))


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_apply_q_and_orgqr_hr_match_jax_on_the_same_factors(driven, case):
    d = driven[case]
    panels = tuple((torch.tensor(y), torch.tensor(t)) for y, t in d["panels"])
    for trans, want in ((False, d["qc"]), (True, d["qtc"])):
        c = torch.tensor(d["c"])
        got = square_hr.apply_q_hr(panels, c, NB, trans=trans)
        assert got is c and rel(got, want) <= 1e-12  # in place
    mp, n = d["ap"].shape
    q = square_hr.orgqr_hr(panels, mp, NB, min(mp, n))
    assert rel(q, d["q"]) <= 1e-12
    # reduced ncols: panels at or past ncols are skipped, the rest agree
    assert rel(square_hr.orgqr_hr(panels, mp, NB, 40), d["q"][:, :40]) <= 1e-12


def test_qr_hr_float32_matches_jax_kernel_route():
    """The JAX chunked driver runs the Pallas panel_apply_carry in float32
    "highest", the same algorithm as the port's driver (B6 for every
    trailing update)."""
    a = np.random.default_rng(3).standard_normal((192, 160)).astype(np.float32)
    ap, _ = square_hr.pad_for_hr(torch.tensor(a), NB)
    jr, jpanels = jhr.qr_hr_chunked(jnp.asarray(ap.numpy()), NB, interpret=True)
    r, panels, _ = square_hr.qr_hr(ap.clone(), NB)
    assert np.abs(r.numpy() - np.asarray(jr)).max() <= 1e-4
    for (y, t), (jy, jt) in zip(panels, jpanels):
        assert np.abs(y.numpy() - np.asarray(jy)).max() <= 1e-4
        assert np.abs(t.numpy() - np.asarray(jt)).max() <= 1e-4


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_pad_for_hr_alpha_is_an_exact_power_of_two(dt):
    """α (the identity block on the padding rows) is 2^ceil(log2 max|A|),
    built from its exponent bits. tileqr's comes from jnp.exp2, which
    rounds on XLA:CPU in float64 (15.999999999999998 for this input, where
    the port has 16; ROADMAP.md queue C), so the two agree to 1e-12
    relative and the rest of the padded matrix bitwise."""
    a = np.random.default_rng(0).standard_normal((100, 70)).astype(dt) * dt(3)
    amax = float(np.abs(a).max())
    ap, (m, n) = square_hr.pad_for_hr(torch.tensor(a), NB)
    jap, _ = jhr.pad_for_hr(jnp.asarray(a), NB)
    jap = np.asarray(jap)
    assert (m, n) == (100, 70) and tuple(ap.shape) == jap.shape == (128, 96)
    alpha = float(ap[m, n])
    assert math.frexp(alpha)[0] == 0.5 and alpha / 2 < amax <= alpha
    idx = np.arange(96 - 70)
    assert np.all(ap.numpy()[m + idx, n + idx] == alpha)
    assert abs(float(jap[m, n]) / alpha - 1) <= 1e-12
    mask = np.ones(jap.shape, bool)
    mask[m + idx, n + idx] = False
    assert np.array_equal(ap.numpy()[mask], jap[mask])
    # no column padding: rows are zero-padded only, no α block
    ap2, _ = square_hr.pad_for_hr(torch.tensor(a[:, :64]), NB)
    assert tuple(ap2.shape) == (128, 64) and not ap2[100:].any()

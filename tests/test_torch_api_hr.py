"""tileqr_torch's public surface on the hr path (``square_method="hr"``)
against tileqr's on the same numpy inputs (JAX on the CPU, Pallas in
interpret mode), its breakdown guard, and hr factors moved between the
two packages.

Tolerances, each with its reason:
- float64 against ``driver="static"`` (the JAX driver whose trailing
  update is XLA dots; the JAX kernel route refuses float64): ≤ 1e-10
  relative Frobenius — 1e-10 and not 1e-11 because CholeskyQR's gram
  squares each panel's condition number;
- float32 against ``driver="dynamic"`` (the JAX kernel route, the same
  algorithm as the port's one driver): ≤ 1e-4 max abs, as
  tests/test_square_hr.py:270;
- the guard fallback: ‖A − QR‖F/‖A‖F < 1e-6, as tests/test_square_hr.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr_torch.interop import hr_factors_from_numpy, hr_factors_to_numpy

TOL = 1e-10
NB = 32
# name: (shape, prescale); the shapes of tests/test_square_hr.py:57
CASES = {
    "square-128": ((128, 128), False),
    "tall-160x96": ((160, 96), False),
    "wide-96x128": ((96, 128), False),
    "unaligned-100x70": ((100, 70), False),
    "unaligned-130x130": ((130, 130), False),
    "prescale-96x96": ((96, 96), True),
}
NCOLS = (None, 8, 40)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def cfgs(dt=np.float64, prescale=False, driver="static", **kw):
    j = tileqr.QRConfig(nb=NB, square_method="hr", driver=driver, prescale=prescale,
                        dtype={np.float64: jnp.float64, np.float32: jnp.float32}[dt], **kw)
    t = tileqr_torch.QRConfig(nb=NB, square_method="hr", prescale=prescale,
                              dtype={np.float64: torch.float64, np.float32: torch.float32}[dt],
                              **kw)
    return j, t


@pytest.fixture(scope="module")
def ref():
    """Each case's inputs and JAX results, computed once."""
    out = {}
    for name, (shape, prescale) in CASES.items():
        rng = np.random.default_rng(sum(shape) + 1)
        a = rng.standard_normal(shape)
        if prescale:
            a = a * 1e150
        c = rng.standard_normal((shape[0], 3))
        jcfg, _ = cfgs(prescale=prescale)
        jf = tileqr.qr_factor(a, jcfg)
        res = {
            "a": a, "c": c, "jf": jf,
            "reduced": tileqr.qr(a, "reduced", jcfg),
            "complete": tileqr.qr(a, "complete", jcfg),
            "qc": tileqr.apply_q(jf, c, trans=False, config=jcfg),
            "qtc": tileqr.apply_q(jf, c, trans=True, config=jcfg),
            "orgqr": {k: tileqr.orgqr(jf, k, jcfg) for k in NCOLS},
        }
        if shape[0] >= shape[1]:
            res["lstsq"] = tileqr.lstsq(a, c, jcfg)
        out[name] = res
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_qr_modes_match_tileqr(ref, case):
    shape, prescale = CASES[case]
    _, tcfg = cfgs(prescale=prescale)
    r = ref[case]
    for mode in ("reduced", "complete"):
        q, rr = tileqr_torch.qr(r["a"], mode, tcfg, device="cpu")
        jq, jr = r[mode]
        assert tuple(q.shape) == jq.shape and tuple(rr.shape) == jr.shape, mode
        assert rel(q, jq) <= TOL and rel(rr, jr) <= TOL, mode
    rr = tileqr_torch.qr(r["a"], "r", tcfg, device="cpu")
    assert tuple(rr.shape) == r["reduced"][1].shape and rel(rr, r["reduced"][1]) <= TOL


@pytest.mark.parametrize("case", list(CASES))
def test_factor_apply_orgqr_match_tileqr(ref, case):
    shape, prescale = CASES[case]
    _, tcfg = cfgs(prescale=prescale)
    r = ref[case]
    f = tileqr_torch.qr_factor(r["a"], tcfg, device="cpu")
    jf = r["jf"]
    assert isinstance(f, tileqr_torch.HRFactors)
    assert (f.nb, f.shape) == (jf.nb, jf.shape) and len(f.panels) == len(jf.panels)
    assert rel(f.r, jf.r) <= TOL
    for (y, t), (jy, jt) in zip(f.panels, jf.panels):
        assert rel(y, jy) <= TOL and rel(t, jt) <= TOL
    assert float(f.health) <= tcfg.hr_guard_tau
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=False), r["qc"]) <= TOL
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=True), r["qtc"]) <= TOL
    for k in NCOLS:
        assert rel(tileqr_torch.orgqr(f, k), r["orgqr"][k]) <= TOL, k


@pytest.mark.parametrize("case", [k for k, v in CASES.items() if v[0][0] >= v[0][1]])
def test_lstsq_matches_tileqr(ref, case):
    shape, prescale = CASES[case]
    _, tcfg = cfgs(prescale=prescale)
    r = ref[case]
    x = tileqr_torch.lstsq(r["a"], r["c"], tcfg, device="cpu")
    assert rel(x, r["lstsq"]) <= TOL
    xv = tileqr_torch.lstsq(r["a"], r["c"][:, 0], tcfg, device="cpu")
    assert xv.shape == (shape[1],) and rel(xv, r["lstsq"][:, 0]) <= TOL


@pytest.mark.parametrize("shape", [(128, 128), (160, 96)])
def test_float32_matches_tileqr_kernel_route(shape):
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    jcfg, tcfg = cfgs(np.float32, driver="dynamic")
    jq, jr = tileqr.qr(a, config=jcfg)
    q, r = tileqr_torch.qr(a, config=tcfg, device="cpu")
    assert np.abs(q.numpy() - np.asarray(jq)).max() <= 1e-4
    assert np.abs(r.numpy() - np.asarray(jr)).max() <= 1e-4


def _near_singular(rng, m=160, n=128):
    """tests/test_square_hr.py's breakdown input: a near-duplicate column
    pair makes the panel-0 gram numerically singular in fp32."""
    b = rng.standard_normal((m, n)).astype(np.float32)
    b[:, 1] = b[:, 0] * (1 + 1e-7)
    return b


def test_hr_guard_fallback_gives_the_hh_factors(rng):
    """hr_guard="fallback" (the default) warns and refactors on the hh
    path with the already prescaled A: the factors are those of hh."""
    b = _near_singular(rng, m=96, n=64)
    cfg = tileqr_torch.QRConfig(nb=NB, square_method="hr", prescale=True)
    with pytest.warns(UserWarning, match="hr guard"):
        f = tileqr_torch.qr_factor(b, cfg, device="cpu")
    assert isinstance(f, tileqr_torch.QRFactors)
    hh = tileqr_torch.qr_factor(b, tileqr_torch.QRConfig(nb=NB, prescale=True), device="cpu")
    assert torch.equal(f.packed, hh.packed) and float(f.scale) == float(hh.scale)
    with pytest.warns(UserWarning, match="hr guard"):
        q, r = tileqr_torch.qr(b, config=cfg, device="cpu")
    q64, r64 = q.double().numpy(), r.double().numpy()
    assert np.linalg.norm(q64 @ r64 - b) / np.linalg.norm(b) < 1e-6
    with pytest.warns(UserWarning, match="hr guard"):  # the JAX package agrees
        jf = tileqr.qr_factor(b, tileqr.QRConfig(nb=NB, square_method="hr", prescale=True))
    assert type(jf).__name__ == "QRFactors"


def test_hr_guard_warn_and_off(rng):
    """"warn" keeps the hr factors with the health past tau; "off" runs no
    check and attaches no health."""
    b = _near_singular(rng)
    cfg = tileqr_torch.QRConfig(nb=NB, square_method="hr", hr_guard="warn")
    with pytest.warns(UserWarning, match="hr guard"):
        f = tileqr_torch.qr_factor(b, cfg, device="cpu")
    assert isinstance(f, tileqr_torch.HRFactors)
    assert not float(f.health) <= cfg.hr_guard_tau  # NaN or past tau
    off = tileqr_torch.QRConfig(nb=NB, square_method="hr", hr_guard="off")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f2 = tileqr_torch.qr_factor(b, off, device="cpu")
    assert isinstance(f2, tileqr_torch.HRFactors) and f2.health is None


@pytest.mark.parametrize("case", ["unaligned-100x70", "prescale-96x96"])
def test_interop_hr_factors_both_ways(ref, case):
    """JAX HRFactors drive the port's apply_q/orgqr, and the port's drive
    tileqr.apply_q."""
    shape, prescale = CASES[case]
    jcfg, tcfg = cfgs(prescale=prescale)
    r = ref[case]
    f = hr_factors_from_numpy(r["jf"])
    assert isinstance(f, tileqr_torch.HRFactors) and f.r.device.type == "cpu"
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=True), r["qtc"]) <= TOL
    assert rel(tileqr_torch.orgqr(f), r["orgqr"][None]) <= TOL
    back = hr_factors_to_numpy(tileqr_torch.qr_factor(r["a"], tcfg, device="cpu"))
    jf = tileqr.HRFactors(**back)
    assert rel(tileqr.apply_q(jf, r["c"], trans=False, config=jcfg), r["qc"]) <= TOL
    assert rel(jf.r, r["jf"].r) <= TOL and float(jf.health) <= jcfg.hr_guard_tau

"""tileqr_torch's public surface against tileqr's (QRConfig(driver="static"),
JAX on the CPU with Pallas in interpret mode) on the same numpy inputs.

float64: relative Frobenius difference <= 1e-11. float32: <= 1e-5 (the
relerr level; the two packages round differently).
"""

import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch
from tileqr_torch.interop import factors_from_numpy, factors_to_numpy

TOL = {np.float64: 1e-11, np.float32: 1e-5}
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}
TDT = {np.float64: torch.float64, np.float32: torch.float32}

# name: (shape, nb, chunk, prescale, dtype)
CASES = {
    "unaligned-f64": ((100, 70), 32, 4, False, np.float64),
    "tall-f64": ((224, 96), 32, 4, False, np.float64),
    "wide-f64": ((64, 150), 32, 4, False, np.float64),
    "prescale-f64": ((96, 96), 32, 2, True, np.float64),
    "unaligned-f32": ((100, 70), 32, 4, False, np.float32),
    "tall-prescale-f32": ((224, 96), 32, 4, True, np.float32),
}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def cfgs(nb, chunk, prescale, dt):
    j = tileqr.QRConfig(nb=nb, ib=nb // 2, chunk=chunk, prescale=prescale,
                        dtype=JDT[dt], driver="static")
    t = tileqr_torch.QRConfig(nb=nb, ib=nb // 2, chunk=chunk, prescale=prescale,
                              dtype=TDT[dt])
    return j, t


@pytest.fixture(scope="module")
def ref():
    """Each case's inputs and JAX results, computed once."""
    out = {}
    for name, (shape, nb, chunk, prescale, dt) in CASES.items():
        rng = np.random.default_rng(sum(shape))
        a = rng.standard_normal(shape).astype(dt)
        if prescale:
            a = a * dt(1e30 if dt is np.float32 else 1e150)
        c = rng.standard_normal((shape[0], 3)).astype(dt)
        jcfg, _ = cfgs(nb, chunk, prescale, dt)
        jf = tileqr.qr_factor(a, jcfg)
        res = {
            "a": a, "c": c, "jf": jf,
            "reduced": tileqr.qr(a, "reduced", jcfg),
            "complete": tileqr.qr(a, "complete", jcfg),
            "r": tileqr.qr(a, "r", jcfg),
            "qc": tileqr.apply_q(jf, c, trans=False, config=jcfg),
            "qtc": tileqr.apply_q(jf, c, trans=True, config=jcfg),
            "orgqr": tileqr.orgqr(jf, None, jcfg),
        }
        if shape[0] >= shape[1]:
            res["lstsq"] = tileqr.lstsq(a, c, jcfg)
        out[name] = res
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_qr_modes_match_tileqr(ref, case):
    shape, nb, chunk, prescale, dt = CASES[case]
    _, tcfg = cfgs(nb, chunk, prescale, dt)
    r = ref[case]
    for mode in ("reduced", "complete"):
        q, rr = tileqr_torch.qr(r["a"], mode, tcfg, device="cpu")
        jq, jr = r[mode]
        assert tuple(q.shape) == jq.shape and tuple(rr.shape) == jr.shape
        assert rel(q, jq) <= TOL[dt] and rel(rr, jr) <= TOL[dt], mode
    rr = tileqr_torch.qr(r["a"], "r", tcfg, device="cpu")
    assert tuple(rr.shape) == r["r"].shape and rel(rr, r["r"]) <= TOL[dt]


@pytest.mark.parametrize("case", list(CASES))
def test_factor_apply_orgqr_match_tileqr(ref, case):
    shape, nb, chunk, prescale, dt = CASES[case]
    _, tcfg = cfgs(nb, chunk, prescale, dt)
    r = ref[case]
    f = tileqr_torch.qr_factor(r["a"], tcfg, device="cpu")
    jf = r["jf"]
    assert (f.nb, f.chunk, f.shape) == (jf.nb, jf.chunk, jf.shape)
    # the port's scale is an exact power of two; tileqr's comes from
    # jnp.exp2, which rounds on XLA:CPU (ROADMAP.md queue C)
    assert math.frexp(float(f.scale))[0] == 0.5
    assert abs(float(f.scale) / float(jf.scale) - 1) <= TOL[dt]
    for g, w in ((f.packed, jf.packed), (f.r_diag, jf.r_diag), (f.t_geqrt, jf.t_geqrt)):
        assert rel(g, w) <= TOL[dt]
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=False), r["qc"]) <= TOL[dt]
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=True), r["qtc"]) <= TOL[dt]
    assert rel(tileqr_torch.orgqr(f), r["orgqr"]) <= TOL[dt]


@pytest.mark.parametrize("case", [k for k, v in CASES.items() if v[0][0] >= v[0][1]])
def test_lstsq_matches_tileqr(ref, case):
    shape, nb, chunk, prescale, dt = CASES[case]
    _, tcfg = cfgs(nb, chunk, prescale, dt)
    r = ref[case]
    x = tileqr_torch.lstsq(r["a"], r["c"], tcfg, device="cpu")
    assert rel(x, r["lstsq"]) <= TOL[dt]
    xv = tileqr_torch.lstsq(r["a"], r["c"][:, 0], tcfg, device="cpu")
    assert xv.shape == (shape[1],) and rel(xv, r["lstsq"][:, 0]) <= TOL[dt]


@pytest.mark.parametrize("bad", [(5,), (2, 3, 4), (0, 4), (4, 0)])
@pytest.mark.parametrize("entry", ["qr", "qr_factor", "lstsq"])
def test_rejects_non_matrix_and_zero_size(entry, bad):
    a = np.zeros(bad)
    with pytest.raises(ValueError):
        if entry == "lstsq":
            tileqr_torch.lstsq(a, np.zeros(bad[0] if bad else 1))
        else:
            getattr(tileqr_torch, entry)(a)


def test_caller_tensor_unchanged(rng):
    a = torch.tensor(rng.standard_normal((64, 64)))
    before = a.clone()
    cfg = tileqr_torch.QRConfig(nb=32, dtype=torch.float64)
    tileqr_torch.qr(a, config=cfg)
    tileqr_torch.qr_factor(a, cfg)
    assert torch.equal(a, before)


def test_unported_settings_raise():
    """Every precision runs on both square paths (ROADMAP.md queue A item
    7). What still raises: "b3"/"b4" where the reference hands the mode to
    an XLA product that refuses it (here ``qr_batched``; every such entry is
    held against tileqr in tests/test_torch_precision_api.py), and a
    precision that is no mode."""
    a = np.eye(32)
    for method in ("hh", "hr"):
        cfg = tileqr_torch.QRConfig(nb=32, square_method=method, precision="b3")
        q, r = tileqr_torch.qr(a, config=cfg, device="cpu")
        assert torch.allclose(q @ r, torch.eye(32), atol=1e-5)
    with pytest.raises(ValueError, match="'b3'.*qr_batched"):
        tileqr_torch.qr_batched(a[None], config=tileqr_torch.QRConfig(nb=32, precision="b3"),
                                device="cpu")
    with pytest.raises(ValueError, match="precision='bf16'"):
        tileqr_torch.qr(a, config=tileqr_torch.QRConfig(nb=32, precision="bf16"), device="cpu")


@pytest.mark.parametrize("entry", ["qr", "qr_factor", "lstsq"])
def test_numpy_input_goes_to_the_card(monkeypatch, entry):
    """A non-tensor input with no ``device`` goes to the card: with no CUDA
    device it raises before any plain kernel version runs on the CPU."""
    from tileqr_torch.kernels import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.random.default_rng(0).standard_normal((64, 64))
    cfg = tileqr_torch.QRConfig(nb=32, dtype=torch.float64)
    _build.reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "lstsq":
            tileqr_torch.lstsq(a, a[:, 0], cfg)
        else:
            getattr(tileqr_torch, entry)(a, config=cfg)
    assert not any(_build.PLAIN_CALLS.values())
    # a CPU tensor, or device="cpu", runs the plain versions on the CPU
    assert tileqr_torch.qr(torch.tensor(a), "r", cfg).device.type == "cpu"
    assert tileqr_torch.qr(a, "r", cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="device="):
        tileqr_torch.qr(torch.tensor(a), "r", cfg, device="cuda")


def test_config_validation_matches_tileqr():
    for kw in ({"nb": 48, "ib": 40}, {"nb": 256}, {"nb": 64, "ib": 512}):
        assert tileqr_torch.QRConfig(**kw).ib == tileqr.QRConfig(**kw).ib
    for bad in ({"nb": 30}, {"driver": "x"}, {"square_method": "x"}, {"ib": 0}):
        with pytest.raises(ValueError):
            tileqr_torch.QRConfig(**bad)


@pytest.mark.parametrize("case", ["unaligned-f64", "prescale-f64"])
def test_interop_factors_both_ways(ref, case):
    """JAX factors drive the port's apply_q, and the port's drive JAX's."""
    shape, nb, chunk, prescale, dt = CASES[case]
    jcfg, tcfg = cfgs(nb, chunk, prescale, dt)
    r = ref[case]
    f = factors_from_numpy(r["jf"])
    assert rel(tileqr_torch.apply_q(f, r["c"], trans=True), r["qtc"]) <= TOL[dt]
    assert rel(tileqr_torch.orgqr(f), r["orgqr"]) <= TOL[dt]
    back = factors_to_numpy(tileqr_torch.qr_factor(r["a"], tcfg, device="cpu"))
    jf = tileqr.QRFactors(**back)
    assert rel(tileqr.apply_q(jf, r["c"], trans=False, config=jcfg), r["qc"]) <= TOL[dt]


def test_import_leaves_jax_out():
    """Importing the port (its interop module and every driver and kernel
    module included) imports no jax, jaxlib or tileqr module."""
    code = (
        "import sys; before = set(sys.modules)\n"
        "import tileqr_torch, tileqr_torch.interop, tileqr_torch.kernels.chain\n"
        "import tileqr_torch.drivers.square_hr, tileqr_torch.drivers.cholqr\n"
        "import tileqr_torch.kernels.modlu, tileqr_torch.kernels.potrf\n"
        "import tileqr_torch.kernels.panel_apply, tileqr_torch.utils.profile\n"
        "import tileqr_torch.drivers.tsqr, tileqr_torch.drivers.batched\n"
        "import tileqr_torch.kernels.geqrt\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'tileqr')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"

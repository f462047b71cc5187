"""tileqr_torch's hh path past 32 panels, where tileqr's "auto" takes its
dynamic driver (``tileqr/core/config.py:resolve_driver``,
``drivers/square_dyn.py``). The port's one driver stands in for both of
tileqr's; the other CPU tests hold it to the static one at 3 to 5 panels.

272² at nb = 8, ib = 4, chunk = 4: 34 panels, with head couples, chunk
couples and a lone GEQRT as at 16384² and nb = 256 (64 panels).

- float64, against tileqr's own route there: R, Q (``qr``, reduced) and
  the Q that ``orgqr`` forms from ``qr_factor``'s factors, each to 1e-11
  relative (the same algebra in float64: R reads 1.4e-15 apart, Q 1.1e-14).
- Against the benchmark's plain reference (``qrbench/reference/
  householder.py``, torch only, panels of 32 by ``torch.geqrf``): float64
  ``r_gap`` ≤ 1e-11. In fp32, each number in float64 against the
  reference's float64 R, as ``qrbench/judge.py`` computes it:
  - r_gap ‖D·R − R_ref‖F/‖R_ref‖F ≤ 1e-5: R's forward error, near the
    backward error for a gaussian A; fp32 reads 9.9e-7;
  - resid ‖A − QR‖F/‖A‖F ≤ 5e-6: Householder's backward error, a small
    multiple of √n·u (u = 2^-24, √272·u = 9.8e-7); fp32 reads 5.5e-7;
  - orth ‖QᵀQ − I‖F ≤ 5e-5: n entries a row of √n·u each, n·u = 1.6e-5;
    fp32 reads 1.1e-5.
  The reference with TF32 products (u = 2^-11) reads 8.0e-4 / 9.4e-4 /
  1.9e-2 and fails each; in IEEE fp32 (5.8e-7 / 6.2e-7 / 1.1e-5) it passes
  each.
- The counters of a 64-panel ``qr`` (``_build.PIPELINE``, ``EXCHANGE``,
  ``STRIP``, ``trace.LOOKAHEAD``) as ``tests/_hh_counts.py:planned_hh_counts``
  derives them from the driver's segments and the plans: the wrappers'
  host side run on CPU tensors through a stubbed kernel library, and the
  derivation at 16384², which the card test holds the card's counts to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch
from _hh_counts import planned_hh_counts
from qrbench import judge
from qrbench.reference import householder as ref
from tests.test_torch_cluster_plan import StubLib
from tileqr_torch.core import trace
from tileqr_torch.kernels import _build

N, NB, IB, CHUNK = 272, 8, 4, 4
F64_TOL = 1e-11
F32_TOL = {"r_gap": 1e-5, "resid": 5e-6, "orth": 5e-5}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def gaussian(dtype):
    return np.random.default_rng(N).standard_normal((N, N)).astype(dtype)


@pytest.fixture(scope="module")
def jax_f64():
    """tileqr's answers in float64 by its "auto" driver: (Q, R) of ``qr``
    and ``orgqr`` of ``qr_factor``'s factors."""
    cfg = tileqr.QRConfig(nb=NB, ib=IB, chunk=CHUNK, dtype=jnp.float64)
    assert cfg.resolve_driver(N, N) == "dynamic"
    a = gaussian(np.float64)
    q, r = tileqr.qr(a, "reduced", cfg)
    return a, {"q": np.asarray(q), "r": np.asarray(r),
               "orgqr": np.asarray(tileqr.orgqr(tileqr.qr_factor(a, cfg), None, cfg))}


def port(a):
    cfg = tileqr_torch.QRConfig(nb=NB, ib=IB, chunk=CHUNK, dtype=a.dtype)
    q, r = tileqr_torch.qr(a, config=cfg)
    return q, r, tileqr_torch.orgqr(tileqr_torch.qr_factor(a, cfg), None, cfg)


def test_float64_matches_tileqrs_dynamic_driver(jax_f64):
    a, want = jax_f64
    q, r, qo = port(torch.from_numpy(a))
    got = {"q": q, "r": r, "orgqr": qo}
    for key in want:
        assert rel(got[key], want[key]) <= F64_TOL, (key, rel(got[key], want[key]))


def test_float64_matches_the_plain_reference():
    a = torch.from_numpy(gaussian(np.float64))
    _, r, _ = port(a)
    assert judge.r_gap(r, ref.qr(a).r) <= F64_TOL


def f32_numbers(a, q, r, r_ref):
    return {"r_gap": judge.r_gap(r, r_ref), "resid": judge.resid_qr(a, q, r),
            "orth": judge.orth_q(q)}


@pytest.fixture(scope="module")
def f32_case():
    a = torch.from_numpy(gaussian(np.float32))
    return a, ref.qr(a).r


def test_float32_meets_every_tolerance(f32_case):
    a, r_ref = f32_case
    q, r, _ = port(a)
    got = f32_numbers(a, q, r, r_ref)
    for key, tol in F32_TOL.items():
        assert got[key] <= tol, (key, got[key])


@pytest.mark.parametrize("precision,fails", [("tf32", True), ("ieee", False)])
def test_the_tolerances_fail_the_tf32_reference(f32_case, precision, fails):
    """Tight enough that the reference with TF32 products fails at least
    one (here each); loose enough that it passes each in IEEE fp32."""
    a, r_ref = f32_case
    f = ref.qr(a, dtype=torch.float32, precision=precision, keep=True)
    got = f32_numbers(a, ref.form_q(f, precision), f.r, r_ref)
    over = {key for key, tol in F32_TOL.items() if got[key] > tol}
    assert over == (set(F32_TOL) if fails else set()), (precision, got)


@pytest.fixture
def stub_card(monkeypatch):
    monkeypatch.setattr(_build, "is_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", StubLib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: 132)
    _build.reset_counts()
    yield
    _build.reset_counts()


@pytest.mark.parametrize("n,nb,ib", [(1024, 16, 8), (N, NB, IB), (512, 16, 4)], ids=str)
def test_the_counters_are_what_the_plans_give(stub_card, n, nb, ib):
    """qr through the wrappers' card side (a stubbed library, CPU tensors,
    so no side stream: nothing beside) counts what the derivation gives."""
    tileqr_torch.qr(torch.zeros((n, n)), config=tileqr_torch.QRConfig(nb=nb, ib=ib,
                                                                      chunk=CHUNK))
    want = planned_hh_counts(n, nb, ib, CHUNK, 132, side=False)
    assert trace.LOOKAHEAD == want["lookahead"]
    assert _build.PIPELINE == want["pipeline"]
    assert _build.EXCHANGE == want["exchange"]
    assert _build.STRIP == want["strip"]
    assert sum(e["launches"] for e in want["strip"].values()) == _build.LAUNCHES[
        "couple_strip"]
    assert want["k4"] == _build.LAUNCHES["larfb_strip"] == 1


def test_the_derivation_at_16384():
    """64 panels at nb 256: 62 updates split and panels beside a rest, 63
    pipelined launches (all but the lone GEQRT) with 576 steps overlapped,
    every panel's launch exchanging, one K4."""
    want = planned_hh_counts(16384, 256, 128, 4, 132)
    assert want["lookahead"] == {"split": 62, "beside": 62}
    assert want["pipeline"] == {"launches": 63, "overlapped_steps": 576}
    assert want["exchange"]["launches"] == 64 and want["k4"] == 1

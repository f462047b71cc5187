"""``tileqr_torch.qr_batched`` on both routes against the benchmark's plain
batched reference (``qrbench/reference/householder_batched.py``, torch
only), member by member, on seeded stacks G + 4·√n·I (cond ≲ 3, the
benchmark's ``batched-4096x128`` input) in fp32 on the CPU's plain path.

Each member's numbers, in float64 against the reference's float64 R:
- r_gap ‖D·R − R_ref‖F/‖R_ref‖F (D the diagonal signs) ≤ 1e-5: a forward
  error of R, at most cond·(backward error); with cond ≲ 3 and a
  backward error of a few n·u (u = 2^-24, n ≤ 128: n·u = 7.6e-6), fp32
  reads ~2e-7;
- resid ‖A − QR‖F/‖A‖F ≤ 1e-5: Householder's backward error, n·u;
- orth ‖QᵀQ − I‖F ≤ 1e-4: n·u over the Frobenius norm of n² entries,
  n·u·√n ≈ 8.6e-5 at n = 128; fp32 reads ~3e-6.
The reference in TF32 (operands rounded to 10 mantissa bits, u = 2^-11)
reads 1e-4 / 3e-4 / 4e-3 and fails each of the three.
"""

import pytest
import torch

import tileqr_torch as tq
from qrbench.reference import householder_batched as ref

F64 = torch.float64
TOL = {"r_gap": 1e-5, "resid": 1e-5, "orth": 1e-4}
SHAPES = [(8, 64, 48), (16, 128, 128)]


def _stack(b, m, n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(b, m, n, generator=g, dtype=torch.float32)
    a.diagonal(dim1=-2, dim2=-1).add_(4.0 * n ** 0.5)
    return a


def _numbers(a, q, r, r_ref):
    """Each member's r_gap, resid and orth (B,), in float64."""
    a, q, r = a.to(F64), q.to(F64), r.to(F64)
    fro = lambda x: torch.linalg.norm(x, dim=(-2, -1))  # noqa: E731
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)) * torch.sign(
        torch.diagonal(r_ref, dim1=-2, dim2=-1))
    eye = torch.eye(r.shape[-1], dtype=F64)
    return {"r_gap": fro(d[..., None] * r - r_ref) / fro(r_ref),
            "resid": fro(a - q @ r) / fro(a),
            "orth": fro(q.mT @ q - eye)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("method", ["hh", "cholqr2"])
def test_qr_batched_matches_the_plain_reference_member_by_member(method, shape):
    a = _stack(*shape, seed=sum(shape))
    cfg = tq.QRConfig(batched_method=method)
    q, r = tq.qr_batched(a, config=cfg)
    b, m, n = shape
    assert q.shape == (b, m, n) and r.shape == (b, n, n) and q.dtype == torch.float32
    assert torch.equal(r, torch.triu(r))
    got = _numbers(a, q, r, ref.qr(a).r)
    for key, tol in TOL.items():
        assert got[key].shape == (b,)
        assert got[key].max() <= tol, (key, got[key].max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_a_tf32_rounded_answer_fails_every_tolerance(shape):
    """The tolerances are tight: the reference with TF32-rounded products
    breaks each of them, the same reference in IEEE fp32 none."""
    a = _stack(*shape, seed=sum(shape))
    r_ref = ref.qr(a).r
    for precision, fails in (("tf32", True), ("ieee", False)):
        f = ref.qr(a, dtype=torch.float32, precision=precision, keep=True)
        got = _numbers(a, ref.form_q(f, precision), f.r, r_ref)
        for key, tol in TOL.items():
            assert bool(got[key].max() > tol) is fails, (precision, key, float(got[key].max()))

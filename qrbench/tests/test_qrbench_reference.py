"""The plain reference against numpy.linalg.qr, and its TF32 rounding."""

import numpy as np
import pytest
import torch

from qrbench import spec
from qrbench.judge import verdict
from qrbench.reference import householder as ref


def _signs(r):
    d = np.sign(np.diag(r))
    d[d == 0] = 1
    return d


@pytest.mark.parametrize("shape", [(96, 96), (300, 70), (64, 64), (130, 33)])
@pytest.mark.parametrize("panel", [8, 32])
def test_reference_matches_numpy(shape, panel):
    a = np.random.default_rng(sum(shape)).standard_normal(shape)
    q_np, r_np = np.linalg.qr(a)
    f = ref.qr(torch.from_numpy(a), panel=panel, keep=True)
    r = f.r.numpy()
    d = _signs(r) * _signs(r_np)
    np.testing.assert_allclose(d[:, None] * r, r_np, atol=1e-12 * np.abs(r_np).max())
    q = ref.form_q(f).numpy()
    np.testing.assert_allclose(q * d[None, :], q_np, atol=1e-11)
    y, t = ref.wy(f)
    m, n = shape
    k = min(m, n)
    qfull = np.eye(m) - y.numpy() @ t.numpy() @ y.numpy().T
    np.testing.assert_allclose(qfull[:, :k], q, atol=1e-11)
    np.testing.assert_allclose(qfull.T @ qfull, np.eye(m), atol=1e-11)


@pytest.mark.parametrize("call", ["qr_reduced", "tsqr_r", "tsqr_factor"])
def test_each_call_judges_the_reference_at_rounding_level(call):
    mod = spec.load("calls", call)
    a = torch.randn(200, 40, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    f = ref.qr(a, keep=True)
    ans = {"qr_reduced": lambda: (ref.form_q(f), f.r), "tsqr_r": lambda: f.r,
           "tsqr_factor": lambda: (*ref.wy(f), f.r)}[call]()
    nums = mod.numbers(a, ans, ref.qr(a).r)
    assert mod.BACKWARD in nums
    assert max(nums.values()) < 1e-13, nums
    # R is unique up to the signs of its rows
    if call == "tsqr_r":
        assert mod.numbers(a, -f.r, ref.qr(a).r)["r_gap"] < 1e-13


@pytest.mark.parametrize("call", ["qr_reduced", "tsqr_r", "tsqr_factor"])
def test_each_call_refuses_a_wrong_shape(call):
    mod = spec.load("calls", call)
    a = torch.randn(50, 10, dtype=torch.float64)
    ans = mod.reference(ref, a.float(), "ieee")
    ans = ans[:, :-1] if call == "tsqr_r" else (*ans[:-1], ans[-1][:, :-1])
    with pytest.raises(ValueError):
        mod.numbers(a, ans, ref.qr(a).r)


def test_verdict_holds_each_number_to_its_limit():
    got = verdict({"r_gap": 1e-7, "resid": float("nan")}, {"r_gap": 1e-6, "resid": 1.0,
                                                         "orth": 1.0})
    assert got["r_gap"] == {"value": 1e-7, "limit": 1e-6, "ok": True}
    assert not got["resid"]["ok"] and got["resid"]["value"] is None
    assert not got["orth"]["ok"]
    assert not verdict({"r_gap": 2e-6}, {"r_gap": 1e-6})["r_gap"]["ok"]


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    y = ref.tf32_round(x)
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((y - x).abs() / x.abs()).max()
    assert 2.0**-12 < rel <= 2.0**-11
    assert torch.equal(ref.tf32_round(y), y)

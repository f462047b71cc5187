"""The hr guard's contract on one panel, in tileqr and in tileqr_torch.

The hr panel's CholeskyQR round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max
grows as cond(panel)²·eps, so the guard (``hr_guard_tau`` = 0.05) trips
past cond ≈ 1e3 in fp32. On a square gaussian the last panels are the
near-square trailing blocks, whose condition is heavy-tailed over draws:
one 16384² draw's last 256² panel has cond ≈ 2.4e4. The test holds
tileqr's ``hr_panel`` (Pallas in interpret mode) and the port's (plain
versions) to the same side of the guard on fp32 256² panels of a set
condition number, made from a seed, with one small singular value (as a
gaussian block's spectrum has): both below it at cond ≤ 1e2, both past
it, finite, at cond ≥ 2.4e4. As a script it prints the condition number and
both defects on a panel saved by ``tileqr_torch/utils/hr_guard_probe.py``:

    python tests/test_torch_hr_guard_contract.py PANEL.npy
"""

import os
import sys

if __name__ == "__main__":  # the suite's conftest does this under pytest
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tileqr.drivers import square_hr as jhr  # noqa: E402
from tileqr_torch import QRConfig  # noqa: E402
from tileqr_torch.drivers import square_hr as thr  # noqa: E402

TAU = QRConfig().hr_guard_tau


def panel_of_cond(cond: float, n: int = 256, seed: int = 0) -> np.ndarray:
    """An fp32 (n, n) panel U diag(s) Vᵀ, U and V the Q factors of
    gaussians, s from 1 down to 0.5 and a last one of 1/cond."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v = np.linalg.qr(rng.standard_normal((n, n)))[0]
    s = np.linspace(1.0, 0.5, n)
    s[-1] = 1.0 / cond
    return ((u * s) @ v.T).astype(np.float32)


def defects(panel: np.ndarray):
    """(tileqr's defect, the port's) on the panel."""
    ref = float(jhr.hr_panel(jax.numpy.asarray(panel), interpret=True, stats=True)[3])
    port = float(thr.hr_panel(torch.from_numpy(panel), stats=True)[3])
    return ref, port


@pytest.mark.parametrize("cond,trips", [(1e1, False), (1e2, False), (2.4e4, True), (1e5, True)],
                         ids=["cond1e1", "cond1e2", "cond2.4e4", "cond1e5"])
def test_both_packages_take_the_same_side_of_the_guard(cond, trips):
    ref, port = defects(panel_of_cond(cond))
    assert np.isfinite(ref) and np.isfinite(port), (ref, port)
    assert (ref > TAU) == trips and (port > TAU) == trips, (ref, port)
    if not trips:  # deep inside the contract, both at fp32 rounding's class
        assert ref <= 1e-3 and port <= 1e-3, (ref, port)


if __name__ == "__main__":
    p = np.load(sys.argv[1])
    s = np.linalg.svd(p.astype(np.float64), compute_uv=False)
    ref, port = defects(p)
    print(f"{sys.argv[1]} {p.shape}: cond {s[0] / s[-1]:.4e}, cond² · 2^-24 "
          f"{(s[0] / s[-1]) ** 2 * 2.0 ** -24:.4e}; round-1 defect: tileqr's hr_panel "
          f"(interpret) {ref:.4e}, the port's (CPU) {port:.4e}; hr_guard_tau {TAU}")

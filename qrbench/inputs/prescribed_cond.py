"""A matrix of prescribed singular values: A = U·diag(σ)·Vᵀ, as LAPACK's
test-matrix generator xLATMS makes it with MODE = 3, σᵢ = cond^(−i/(k−1))
for i = 0 … k−1 (geometric from 1 down to 1/cond, k = min(m, n)).

U (m, k) and V (n, k) are Haar-distributed: the Q of a QR of a gaussian
drawn from the generator, each column's sign fixed by the sign of R's
diagonal (the distribution xLAGGE's products of random reflectors give).
U's gaussian is drawn first, then V's. Everything is made in float64 on the
device and rounded once to ``dtype``, so the stated spectrum holds to that
rounding and no TF32 product enters; the float64 factors are freed before
the return."""

import torch


def _haar(rows: int, cols: int, generator, device) -> torch.Tensor:
    g = torch.randn((rows, cols), generator=generator, dtype=torch.float64, device=device)
    q, r = torch.linalg.qr(g)
    del g
    d = torch.sign(torch.diagonal(r))
    q *= torch.where(d == 0, torch.ones_like(d), d)
    return q


def sigma(k: int, cond: float, device=None) -> torch.Tensor:
    """The k singular values in float64, largest first."""
    i = torch.arange(k, dtype=torch.float64, device=device)
    return float(cond) ** (-i / max(k - 1, 1))


def make(shape, dtype, generator, device, cond, spectrum):
    if spectrum != "geometric":
        raise ValueError(f"spectrum {spectrum!r}: only 'geometric' (xLATMS MODE = 3)")
    m, n = shape
    k = min(m, n)
    u = _haar(m, k, generator, device)
    v = _haar(n, k, generator, device)
    u *= sigma(k, cond, device)
    a = (u @ v.T).to(dtype)
    del u, v
    return a

"""Plain blocked Householder QR of a stack of matrices: the benchmark's
reference for ``qr_batched``, torch only.

The algorithm of ``householder.py`` run on every member of a (B, m, n)
stack at once. It imports nothing of the program under test and takes
nothing the program made. Panels of ``panel`` columns are factored by
``torch.geqrf`` on the (B, m − j, w) panel stack in the working dtype; the
trailing columns are updated with each member's compact-WY pair,
Qᵀ·C = C − Y·Tᵀ·(Yᵀ·C), and Q is formed, by batched products in
``precision``: "ieee" (the working dtype's own products: float64 for the
reference, float32 with TF32 off) or "tf32" (the control; ``householder.mm``
says how it is rounded). T of each member's block of reflectors comes from
T⁻¹ = striu(YᵀY) + diag(1/τ), so that Q = I − Y·T·Yᵀ over the block.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from qrbench.reference.householder import mm


class Factors(NamedTuple):
    """R (B, k, n), and per panel (column offset, Y (B, m − j, w),
    T (B, w, w), τ (B, w)) where the reflectors were kept."""

    r: torch.Tensor
    panels: List[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]
    shape: Tuple[int, int, int]


def t_of(y: torch.Tensor, tau: torch.Tensor, precision: str) -> torch.Tensor:
    """T (B, k, k) of the reflectors y (B, m, k) (unit lower trapezoid) and τ."""
    g = mm(y.mT, y, precision)
    u = torch.triu(g, 1) + torch.diag_embed(1.0 / tau)
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device).expand_as(u)
    return torch.linalg.solve_triangular(u, eye, upper=True)


def _unit_lower(pa: torch.Tensor) -> torch.Tensor:
    w = pa.shape[-1]
    y = torch.tril(pa, -1)
    y[:, :w].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return y


def qr(a: torch.Tensor, dtype: torch.dtype = torch.float64, precision: str = "ieee",
       panel: int = 32, keep: bool = False) -> Factors:
    """Blocked Householder QR of every member of a (B, m, n) in ``dtype``;
    with ``keep`` the panels' reflectors are kept for ``form_q``."""
    a = a.to(dtype=dtype).clone()
    b, m, n = a.shape
    k = min(m, n)
    panels = []
    for j in range(0, k, panel):
        w = min(panel, k - j)
        pa, tau = torch.geqrf(a[:, j:, j:j + w])
        y = _unit_lower(pa)
        a[:, j:, j:j + w] = torch.triu(pa)
        if j + w < n or keep:
            t = t_of(y, tau, precision)
        if j + w < n:
            c = a[:, j:, j + w:]
            c -= mm(y, mm(t.mT, mm(y.mT, c, precision), precision), precision)
        if keep:
            panels.append((j, y, t, tau))
        del pa, y
    return Factors(torch.triu(a[:, :k]), panels, (b, m, n))


def form_q(f: Factors, precision: str = "ieee") -> torch.Tensor:
    """The reduced Q (B, m, k), the panels applied to [I; 0] last to first,
    each to the columns right of its offset only."""
    b, m, n = f.shape
    k = min(m, n)
    q = torch.eye(m, k, dtype=f.r.dtype, device=f.r.device).repeat(b, 1, 1)
    for j, y, t, _ in reversed(f.panels):
        c = q[:, j:, j:]
        c -= mm(y, mm(t, mm(y.mT, c, precision), precision), precision)
    return q

"""Plain blocked Householder QR: the benchmark's reference, torch only.

It imports nothing of the program under test and takes nothing the program
made: it is handed the benchmark's own input and works out its factors
from scratch. Panels of ``panel`` columns are factored by ``torch.geqrf``
in the working dtype; the trailing columns are updated with the panel's
compact-WY pair, Qᵀ·C = C − Y·Tᵀ·(Yᵀ·C), by products in ``precision``:

  "ieee"  the working dtype's own products: float64 for the reference,
          float32 with TF32 off for an fp32 run of the same algorithm.
  "tf32"  float32 products on TF32 operands (10-bit mantissa, fp32 sums):
          the control, the nearest precision below the configurations'
          IEEE fp32. On a card the products run with TF32 switched on; on
          the CPU, which has no TF32, each operand is rounded to TF32 first.

T of a block of reflectors comes from T⁻¹ = striu(YᵀY) + diag(1/τ) (the
reflectors I − τ·y·yᵀ of LAPACK's geqrf have τ = 2/yᵀy), so that
Q = I − Y·T·Yᵀ over the block.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import torch

class Factors(NamedTuple):
    """R (k, n), and per panel (column offset, Y (m − j, w), T (w, w), τ (w,))
    where the reflectors were kept."""

    r: torch.Tensor
    panels: List[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]
    shape: Tuple[int, int]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


@contextlib.contextmanager
def _tf32_on(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in ``precision`` (the module docstring)."""
    if precision == "ieee":
        with _tf32_on(False):
            return a @ b
    if precision != "tf32" or a.dtype != torch.float32:
        raise ValueError(f"precision {precision!r} on {a.dtype}")
    if a.is_cuda:
        with _tf32_on(True):
            return a @ b
    return tf32_round(a) @ tf32_round(b)


def t_of(y: torch.Tensor, tau: torch.Tensor, precision: str) -> torch.Tensor:
    """T (k, k) of the reflectors y (m, k) (unit lower trapezoid) and τ."""
    g = mm(y.T, y, precision)
    u = torch.triu(g, 1) + torch.diag(1.0 / tau)
    eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
    return torch.linalg.solve_triangular(u, eye, upper=True)


def _unit_lower(pa: torch.Tensor) -> torch.Tensor:
    w = pa.shape[1]
    y = torch.tril(pa, -1)
    y[:w].diagonal().fill_(1.0)
    return y


def qr(a: torch.Tensor, dtype: torch.dtype = torch.float64, precision: str = "ieee",
       panel: int = 32, keep: bool = False) -> Factors:
    """Blocked Householder QR of a (m, n) in ``dtype``; with ``keep`` the
    panels' reflectors are kept for ``form_q`` and ``wy``."""
    a = a.to(dtype=dtype).clone()
    m, n = a.shape
    k = min(m, n)
    panels = []
    for j in range(0, k, panel):
        w = min(panel, k - j)
        pa, tau = torch.geqrf(a[j:, j:j + w])
        y = _unit_lower(pa)
        a[j:, j:j + w] = torch.triu(pa)
        if j + w < n or keep:
            t = t_of(y, tau, precision)
        if j + w < n:
            c = a[j:, j + w:]
            c -= mm(y, mm(t.T, mm(y.T, c, precision), precision), precision)
        if keep:
            panels.append((j, y, t, tau))
        del pa, y
    return Factors(torch.triu(a[:k]), panels, (m, n))


def form_q(f: Factors, precision: str = "ieee") -> torch.Tensor:
    """The reduced Q (m, k), the panels applied to [I; 0] last to first,
    each to the columns right of its offset only."""
    m, n = f.shape
    k = min(m, n)
    q = torch.eye(m, k, dtype=f.r.dtype, device=f.r.device)
    for j, y, t, _ in reversed(f.panels):
        c = q[j:, j:]
        c -= mm(y, mm(t, mm(y.T, c, precision), precision), precision)
    return q


def wy(f: Factors, precision: str = "ieee") -> Tuple[torch.Tensor, torch.Tensor]:
    """One compact-WY pair over all k reflectors: Y (m, k) unit lower
    trapezoid and T (k, k), with Q = I − Y·T·Yᵀ."""
    m, n = f.shape
    k = min(m, n)
    y = torch.zeros(m, k, dtype=f.r.dtype, device=f.r.device)
    taus = []
    for j, yp, _, tau in f.panels:
        y[j:, j:j + yp.shape[1]] = yp
        taus.append(tau)
    return y, t_of(y, torch.cat(taus), precision)

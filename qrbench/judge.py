"""The float64 numbers that decide ``correct``, on the answer's device.

The formulas are frozen copies of ``tileqr_torch/utils/verify.py``'s
(``residuals_f64``: ‖A − QR‖F/‖A‖F and ‖QᵀQ − I‖F; ``backward_error_f64``:
‖QᵀA − R‖F/‖A‖F), here computed in blocks of rows so that a 1048576-row
answer fits beside the program's state. A call module (``calls/``) picks
the ones its answer is judged by:

  r_gap       ‖D·R − R_ref‖F/‖R_ref‖F, the comparison with the plain
              reference: R_ref from ``reference/``'s float64 QR of the same
              input, D the signs that make the two diagonals agree (R is
              unique up to them)
  resid_qr    ‖A − QR‖F/‖A‖F;  orth_q ‖QᵀQ − I‖F
  gram_resid  ‖AᵀA − RᵀR‖F/‖A‖F², for R alone
  resid_wy    ‖QᵀA − [R; 0]‖F/‖A‖F with Qᵀ = I − Y·Tᵀ·Yᵀ;  orth_wy
              ‖Q₁ᵀQ₁ − I‖F of Q's first k columns

``verdict`` holds the numbers to a cell's limits; the run and
``calibrate.py`` both decide by it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

F64 = torch.float64


def _rows(m: int, n: int) -> int:
    """Rows a block of an (m, n) operand: 2^25 float64 elements (256 MiB)."""
    return max(1, min(m, (1 << 25) // max(n, 1)))


def _gram(x: torch.Tensor) -> torch.Tensor:
    """xᵀx in float64, over blocks of rows."""
    m, n = x.shape
    g = torch.zeros(n, n, dtype=F64, device=x.device)
    step = _rows(m, n)
    for i in range(0, m, step):
        xb = x[i:i + step].to(F64)
        g += xb.T @ xb
    return g


def _fro_sq(x: torch.Tensor) -> float:
    m, n = x.shape
    step = _rows(m, n)
    return sum(float(torch.sum(x[i:i + step].to(F64) ** 2)) for i in range(0, m, step))


def check_shape(name: str, t: torch.Tensor, want) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"answer {name} has shape {tuple(t.shape)}, expected {tuple(want)}")


def r_gap(r: torch.Tensor, r_ref: torch.Tensor) -> float:
    r, r_ref = r.to(F64), r_ref.to(F64)
    d = torch.sign(torch.diagonal(r)) * torch.sign(torch.diagonal(r_ref))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return float(torch.linalg.norm(d[:, None] * r - r_ref) / torch.linalg.norm(r_ref))


def resid_qr(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> float:
    m, n = a.shape
    r64 = r.to(F64)
    num = 0.0
    step = _rows(m, max(n, q.shape[1]))
    for i in range(0, m, step):
        num += float(torch.sum((a[i:i + step].to(F64) - q[i:i + step].to(F64) @ r64) ** 2))
    return math.sqrt(num / _fro_sq(a))


def orth_q(q: torch.Tensor) -> float:
    g = _gram(q)
    g.diagonal().sub_(1.0)
    return float(torch.linalg.norm(g))


def gram_resid(a: torch.Tensor, r: torch.Tensor) -> float:
    r64 = r.to(F64)
    return float(torch.linalg.norm(_gram(a) - r64.T @ r64)) / _fro_sq(a)


def resid_wy(a: torch.Tensor, y: torch.Tensor, t: torch.Tensor, r: torch.Tensor) -> float:
    """‖QᵀA − [R; 0]‖F/‖A‖F, Qᵀ = I − Y·Tᵀ·Yᵀ."""
    m, n = a.shape
    k = y.shape[1]
    step = _rows(m, max(n, k))
    w = torch.zeros(k, n, dtype=F64, device=a.device)
    for i in range(0, m, step):
        w += y[i:i + step].to(F64).T @ a[i:i + step].to(F64)
    z = t.to(F64).T @ w
    r64 = r.to(F64)
    num = 0.0
    for i in range(0, m, step):
        blk = a[i:i + step].to(F64) - y[i:i + step].to(F64) @ z
        top = max(0, min(k, i + step) - i)
        if top:
            blk[:top] -= r64[i:i + top]
        num += float(torch.sum(blk ** 2))
    return math.sqrt(num / _fro_sq(a))


def orth_wy(y: torch.Tensor, t: torch.Tensor) -> float:
    """‖Q₁ᵀQ₁ − I‖F, Q₁ = (I − Y·T·Yᵀ)[:, :k] = E − Y·T·Y₁ᵀ:
    Q₁ᵀQ₁ − I = −Y₁TY₁ᵀ − Y₁TᵀY₁ᵀ + Y₁Tᵀ(YᵀY)TY₁ᵀ."""
    k = y.shape[1]
    g = _gram(y)
    y1, t64 = y[:k].to(F64), t.to(F64)
    d = -y1 @ t64 @ y1.T - y1 @ t64.T @ y1.T + y1 @ t64.T @ g @ t64 @ y1.T
    return float(torch.linalg.norm(d))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each limited number beside its limit: ok where it is finite and at
    most the limit; a number the answer did not give is not ok."""
    out = {}
    for key, limit in limits.items():
        v = numbers.get(key)
        ok = v is not None and math.isfinite(v) and v <= limit
        out[key] = {"value": v if v is not None and math.isfinite(v) else None,
                    "limit": limit, "ok": ok}
    return out

"""Batched upper Cholesky (B9): G (B, n, n) SPD → R upper with RᵀR = G.

Counterpart of ``tileqr/drivers/cholqr.py:potrf_batched``
(``_mk_potrf_kernel``): rows are factored in panels of ``bp`` rows; inside
a panel each row step scales row j by the clamped pivot rsqrt(max(d2,
1e-30)) and rank-1-updates the panel rows below it on the lanes right of
j (the TRSM folded in); after the panel, one SYRK updates the trailing
matrix. The clamp makes a breakdown show up as NaN or a huge value in the
hr health scalar instead of an exception. Zeros are written left of the
diagonal.

On a CUDA tensor the wrapper launches ``tq_potrf_batched``
(``csrc/potrf.cu``, one thread block per matrix); on a CPU tensor it runs
the plain version, which keeps the JAX kernel's bp-row panels and its
symmetric trailing update, so float64 parity is at rounding level. The
reference's ``group`` (matrices per TPU grid step) has no counterpart: the
CUDA grid is the batch.
"""

from __future__ import annotations

import torch

from tileqr_torch.kernels import _build

# the CUDA kernel keeps one bp-row panel (bp·n floats) in shared memory
_MAX_PANEL_BYTES = 200 * 1024


def _check(g: torch.Tensor, bp: int) -> None:
    if g.dim() != 3 or g.shape[1] != g.shape[2]:
        raise ValueError(f"potrf_batched expects (B, n, n), got {tuple(g.shape)}")
    if bp < 1:
        raise ValueError(f"bp={bp} must be >= 1")


def potrf_batched_plain(g: torch.Tensor, bp: int = 16) -> torch.Tensor:
    """Plain torch B9, the JAX kernel's steps on the whole batch."""
    _build.PLAIN_CALLS["potrf_batched"] += 1
    _check(g, bp)
    n = g.shape[1]
    r = g.clone()
    lane = torch.arange(n, device=g.device)
    for s in range(0, n, bp):
        e = min(s + bp, n)
        for j in range(s, e):
            rowv = r[:, j : j + 1, :]  # (B, 1, n)
            colv = r[:, j + 1 : e, j : j + 1]  # panel rows below j, lane j
            rinv = torch.rsqrt(torch.clamp(rowv[:, :, j : j + 1], min=1e-30))
            row_scaled = rowv * rinv
            upd = (colv * rinv) * row_scaled[:, :, j + 1 :]
            r[:, j + 1 : e, j + 1 :] = r[:, j + 1 : e, j + 1 :] - upd
            r[:, j, :] = torch.where(lane >= j, row_scaled[:, 0], 0.0)
        if e < n:
            r12 = r[:, s:e, e:]
            r[:, e:, e:] -= r12.transpose(1, 2) @ r12
    return r


def potrf_batched(g: torch.Tensor, bp: int = 16) -> torch.Tensor:
    """Batched upper Cholesky of g (B, n, n) SPD. Returns R (B, n, n)."""
    if not _build.is_cuda(g):
        return potrf_batched_plain(g, bp)
    _build.require_fp32(g)
    _check(g, bp)
    b, n, _ = g.shape
    if min(bp, n) * n * 4 > _MAX_PANEL_BYTES:
        raise ValueError(f"potrf_batched: a {bp}-row panel of n={n} exceeds shared memory")
    r = g.contiguous().clone()
    rc = _build.lib().tq_potrf_batched(r.data_ptr(), b, n, bp, _build.stream())
    _build.check(rc, "potrf_batched")
    _build.LAUNCHES["potrf_batched"] += 1
    return r

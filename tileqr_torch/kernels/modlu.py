"""Modified LU of the hr panel's top block (B8).

Counterpart of ``tileqr/kernels/modlu.py:modified_lu``: factor

    Q_top − diag(d) = L1 · U

with L1 unit lower triangular, U upper triangular and the signs
d_j = −sign(pivot) chosen at step j (d_j = +1 for a zero pivot), so that
|u_jj| = |q_jj| + 1 ∈ [1, 2] and no pivoting is needed. On a CUDA tensor the
wrapper launches ``tq_modified_lu`` (``csrc/modlu.cu``); on a CPU tensor it
runs the plain version, which follows ``_mk_modlu_kernel`` step by step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels import _build


def _check(q_top: torch.Tensor) -> int:
    if q_top.dim() != 2 or q_top.shape[0] != q_top.shape[1]:
        raise ValueError(f"modified_lu expects a square block, got {tuple(q_top.shape)}")
    return q_top.shape[0]


def modified_lu_plain(q_top: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch B8: the right-looking loop of nb rank-1 steps."""
    _build.PLAIN_CALLS["modified_lu"] += 1
    n = _check(q_top)
    lu = q_top.clone()
    d = lu.new_zeros(n)
    one = lu.new_ones(())
    for j in range(n):
        piv0 = lu[j, j]
        dj = torch.where(piv0 > 0, -one, one)
        piv = piv0 - dj
        lcol = lu[j + 1:, j] / piv
        lu[j + 1:, j + 1:] -= lcol[:, None] * lu[j, j + 1:][None, :]
        lu[j, j] = piv
        lu[j + 1:, j] = lcol
        d[j] = dj
    return lu, d


def modified_lu(q_top: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor q_top − diag(d) = L1·U with on-the-fly signs.

    q_top: (nb, nb), the top block of an orthonormal panel factor.
    Returns (lu, d): lu holds L1 strictly below the diagonal (unit diagonal
    implicit) and U on and above it; d is the (nb,) sign vector (±1).
    """
    if not _build.is_cuda(q_top):
        return modified_lu_plain(q_top)
    _build.require_fp32(q_top)
    n = _check(q_top)
    lu = q_top.contiguous().clone()
    d = torch.empty(n, dtype=lu.dtype, device=lu.device)
    rc = _build.lib().tq_modified_lu(lu.data_ptr(), n, d.data_ptr(), _build.stream())
    _build.check(rc, "modified_lu")
    _build.LAUNCHES["modified_lu"] += 1
    return lu, d

"""Modified LU of the hr panel's top block (B8).

Counterpart of ``tileqr/kernels/modlu.py:modified_lu``: factor

    Q_top − diag(d) = L1 · U

with L1 unit lower triangular, U upper triangular and the signs
d_j = −sign(pivot) chosen at step j (d_j = +1 for a zero pivot), so that
|u_jj| = |q_jj| + 1 ∈ [1, 2] and no pivoting is needed. On a CUDA tensor the
wrapper launches ``tq_modified_lu`` (``csrc/modlu.cu``: a blocked LU on one
thread-block cluster, the block in its CTAs' shared memory, sized by
``modlu_plan``); on a CPU tensor it runs the plain version, which follows
``_mk_modlu_kernel`` step by step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tileqr_torch.kernels import _build

# columns a CTA the plan aims at (a slab of nb × 64 fp32, 64 KiB at nb = 256),
# and the panel width (csrc/modlu.cu: IB): on the H100 ib = 16 ran nb = 256
# and 512 faster than 32 and 64 (PERF.md)
MODLU_COLS_PER_CTA = 64
MODLU_IB = 16


class ModluPlan(NamedTuple):
    ctas: int          # C, the CTAs of the one cluster; CTA q owns columns [q·cpc, (q+1)·cpc)
    ib: int            # panel width, min(MODLU_IB, cpc): the slabs' ib-column pieces
    smem_bytes: int    # dynamic shared memory per CTA
    resident: bool     # the block in shared memory (else in the lu output, L2)


def modlu_panel_width(nb: int, ctas: int) -> int:
    """The panel width of a B8 launch (``csrc/modlu.cu``: ``panel_width``):
    MODLU_IB, or a CTA's ceil(nb / C) columns where it holds fewer."""
    return min(MODLU_IB, -(-nb // ctas))


def modlu_smem_bytes(nb: int, ctas: int, resident: bool) -> int:
    """Shared bytes per CTA of a B8 launch (``csrc/modlu.cu``:
    ``smem_floats``): two parities of a panel row (2 × MODLU_IB), and when
    resident the CTA's slab of ceil(nb / C) columns, all nb rows, row
    stride cpc + 1, and its copy of L's panel, nb × (ib + 1)."""
    cpc = -(-nb // ctas)
    big = nb * (cpc + 1) + nb * (modlu_panel_width(nb, ctas) + 1) if resident else 0
    return 4 * (2 * MODLU_IB + big)


def modlu_plan_at(nb: int, ctas: int) -> ModluPlan:
    """B8's plan on C = ``ctas`` CTAs: the block in their shared memory
    where it fits, else in global memory."""
    if nb < 1 or ctas not in _build.CLUSTER_SIZES:
        raise ValueError(f"modlu_plan_at: nb={nb}, ctas={ctas}")
    resident = modlu_smem_bytes(nb, ctas, True) <= _build.SMEM_LIMIT
    return ModluPlan(ctas, modlu_panel_width(nb, ctas), modlu_smem_bytes(nb, ctas, resident),
                     resident)


def modlu_plan(nb: int) -> ModluPlan:
    """The cluster of a B8 launch on an (nb, nb) block: the fewest CTAs
    (16 at most) that hold at most MODLU_COLS_PER_CTA columns each, grown
    while the slab and the L panel do not fit one CTA's shared memory;
    where none fits, 16 CTAs on the block in global memory."""
    if nb < 1:
        raise ValueError(f"modlu_plan: nb={nb}")
    sizes = _build.CLUSTER_SIZES
    fits = [c for c in sizes if -(-nb // c) <= MODLU_COLS_PER_CTA]
    sizes = sizes[sizes.index(fits[0]):] if fits else sizes[-1:]
    plans = [modlu_plan_at(nb, c) for c in sizes]
    return next((p for p in plans if p.resident), plans[-1])


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
    plan = modlu_plan(_check(q_top))
    out = _launch_modlu(q_top.contiguous(), plan)
    _build.LAUNCHES["modified_lu"] += 1
    return out


def _launch_modlu(q: torch.Tensor, plan: ModluPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One B8 launch on a contiguous CUDA block at ``plan`` (``modlu_plan``'s,
    or ``modlu_plan_at``'s at any C): (lu, d)."""
    n = q.shape[0]
    lu = torch.empty_like(q)
    d = torch.empty(n, dtype=q.dtype, device=q.device)
    rc = _build.lib().tq_modified_lu(q.data_ptr(), lu.data_ptr(), n, d.data_ptr(), plan.ctas,
                                     plan.smem_bytes, int(plan.resident), _build.stream())
    _build.check(rc, "modified_lu")
    return lu, d

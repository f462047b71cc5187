"""TTQRT and TTMQR: the triangle-on-triangle combine of the sharded tree.

Counterpart of ``tileqr/kernels/ttqrt.py``. ``ttqrt`` is the QR of the
couple [R1; R2] of two upper-triangular (nb, nb) tiles: R, V2 (upper
triangular) and T2. On a CUDA tensor the wrapper launches ``tq_ttqrt``
(``csrc/ttqrt.cu``: the thread-block cluster routine of K1/K2 on each
column block's live rows, R1's rows [s, e) and R2's rows [0, e), sized by
``ttqrt_plan``); on a CPU tensor it runs ``ttqrt_plain``, the column
loop with tileqr's row window (``geqrt_in_place``'s ``tri_bottom``: while
the column block [s, e) is eliminated only the first nb + e rows of the
couple are live). Both equal TSQRT on the same couple up to the order of
additions of exact zeros and the order of the sums.

``ttmqr`` applies a TTQRT reflector pair to a tile couple; as in tileqr it
is ``ssrfb`` (``kernels/ssrfb.py``), which runs K3 with one couple on the
card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.geqrt import ClusterPlan, cluster_plan, cluster_plan_at, geqrt_in_place
from tileqr_torch.kernels.ssrfb import ssrfb

# tileqr's ttqrt and tsqrt run the column loop at geqrt_in_refs' default ib
TREE_IB = 128
# live rows a CTA the TTQRT plan aims at (its largest block's set of
# nb + ib rows over C CTAs): 8 CTAs at nb = 256, ib = 128
TTQRT_ROWS_PER_CTA = 48


def ttqrt_rows(nb: int, ib: int) -> int:
    """Live rows of a TTQRT couple's largest block (``geqrt_cluster.cuh``:
    ``tri_rows_max``): R1's ib rows of the block and R2's rows above its
    end, nb + min(ib, nb)."""
    return nb + min(ib, nb)


def ttqrt_plan_at(nb: int, ib: int, ctas: int) -> ClusterPlan:
    """TTQRT's plan on C = ``ctas`` CTAs, ib ≤ nb: the cluster routine's
    (``geqrt.cluster_plan_at``) on the largest live set."""
    if nb < 1 or not 1 <= ib <= nb:
        raise ValueError(f"ttqrt_plan_at: nb={nb}, ib={ib}, ctas={ctas}")
    return cluster_plan_at(nb, ttqrt_rows(nb, ib), ib, ctas)


def ttqrt_plan(nb: int, ib: int) -> ClusterPlan:
    """The cluster of a TTQRT launch (``csrc/ttqrt.cu``, the cluster routine
    on each block's live rows), ib ≤ nb: C from the largest live set,
    ``ttqrt_rows(nb, ib)`` rows, at TTQRT_ROWS_PER_CTA rows a CTA."""
    if nb < 1 or ib < 1 or ib > nb:
        raise ValueError(f"ttqrt_plan: nb={nb}, ib={ib}")
    return cluster_plan(nb, ttqrt_rows(nb, ib), ib, TTQRT_ROWS_PER_CTA)


def _check(r1: torch.Tensor, r2: torch.Tensor) -> int:
    nb = r1.shape[0]
    if r1.dim() != 2 or tuple(r1.shape) != (nb, nb) or tuple(r2.shape) != (nb, nb):
        raise ValueError(f"ttqrt takes two (nb, nb) tiles, got {tuple(r1.shape)} "
                         f"and {tuple(r2.shape)}")
    return nb


def ttqrt_plain(r1: torch.Tensor, r2: torch.Tensor, ib: int = TREE_IB):
    """Plain torch TTQRT: (R, V2, T2)."""
    _build.PLAIN_CALLS["ttqrt"] += 1
    nb = _check(r1, r2)
    at = torch.empty((nb, 2 * nb), dtype=r1.dtype, device=r1.device)
    at[:, :nb] = r1.T
    at[:, nb:] = r2.T
    tt = torch.zeros((nb, nb), dtype=r1.dtype, device=r1.device)
    geqrt_in_place(at, tt, nb, ib, tri_bottom=True)
    return at[:, :nb].T.contiguous(), at[:, nb:].T.contiguous(), tt.T.contiguous()


def ttqrt(r1: torch.Tensor, r2: torch.Tensor,
          ib: int = TREE_IB) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TTQRT: (R1, R2 both (nb, nb) upper triangular) → (R, V2 upper
    triangular, T2). Neither input is written."""
    if not _build.is_cuda(r1, r2):
        return ttqrt_plain(r1, r2, ib)
    _build.require_fp32(r1, r2)
    nb = _check(r1, r2)
    ib = min(ib, nb)
    plan = ttqrt_plan(nb, ib)  # before the library loads: a bad geometry raises first
    out = _launch_ttqrt(r1.contiguous(), r2.contiguous(), ib, plan)
    _build.LAUNCHES["ttqrt"] += 1
    return out


def _launch_ttqrt(r1: torch.Tensor, r2: torch.Tensor, ib: int,
                  plan: ClusterPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TTQRT launch on contiguous CUDA tiles at ``plan`` (``ttqrt_plan``'s,
    or ``ttqrt_plan_at``'s at any C): (R, V2, T2)."""
    nb = r1.shape[0]
    r, v2, t2 = (torch.empty_like(r1) for _ in range(3))
    lib = _build.lib()
    work = r1.new_empty(lib.tq_cluster_work_floats(nb, ttqrt_rows(nb, ib), ib, plan.ctas,
                                                   int(plan.resident)))
    rc = lib.tq_ttqrt(r1.data_ptr(), r2.data_ptr(), nb, ib, r.data_ptr(), v2.data_ptr(),
                      t2.data_ptr(), work.data_ptr(), plan.ctas, plan.smem_bytes,
                      int(plan.resident), _build.stream())
    _build.check(rc, "ttqrt")
    _build.count_exchange(plan.ctas, nb)
    return r, v2, t2


def ttmqr(v2: torch.Tensor, t2: torch.Tensor, c_top: torch.Tensor, c_bot: torch.Tensor,
          trans: bool = True, precision: str = "highest"):
    """TTMQR: apply a TTQRT reflector pair to the couple [C_top; C_bot];
    returns (C_top', C_bot'). V2's strictly-lower zeros make the dense
    SSRFB exact, as in tileqr."""
    return ssrfb(v2, t2, c_top, c_bot, trans=trans, precision=precision)

"""Panel-column factorization K1: GEQRT plus the TSQRT head couples.

Counterpart of ``tileqr/kernels/panel.py:panel_factor``. Step 0 runs GEQRT
on tile (k, k); steps i ≥ 1 run TSQRT on the couple [R; A(k+i, k)], with R
carried from step to step. On a CUDA tensor the wrapper launches the CUDA
kernel ``tq_panel_factor`` (``csrc/panel.cu``); on a CPU tensor it runs the
plain version below. A is read only.

K1 and K2 (``kernels/chain.py``) run as one thread-block cluster a launch
(``csrc/geqrt_cluster.cuh``); ``cluster_plan`` picks its size and where
the active block lives, and the launch is given its numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import triu
from tileqr_torch.kernels.geqrt import geqrt_in_place


# the cluster kernel's constants (csrc/geqrt_cluster.cuh): threads per CTA,
# the chunk width of its block products, its GEMM staging tile and depth
CL_THREADS, CL_CW, CL_GI, CL_GJ, CL_GK = 512, 64, 128, 64, 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# couple rows per CTA the plan aims at: K1's 512 rows on 8 CTAs, K2's
# 1280 on 16 (the nb = 512 chain's 2560 on 16 as well, 160 rows a CTA);
# on the H100 80 rows a CTA ran K1 and K2 faster than 160 (PERF.md)
ROWS_PER_CTA = 80
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may have on the H100


class ClusterPlan(NamedTuple):
    ctas: int          # C, the CTAs of the one cluster
    smem_bytes: int    # dynamic shared memory per CTA
    resident: bool     # the active block, Tb and the work buffer in shared memory
    rows_per_cta: int  # ceil(rows / C): CTA q owns couple rows [q·rpc, (q+1)·rpc)


def cluster_smem_bytes(nb: int, rows: int, ib: int, ctas: int, resident: bool) -> int:
    """Shared bytes per CTA of a K1/K2 launch (``geqrt_cluster.cuh``:
    ``sizes``/``smem_floats``): GEMM staging, column partials (two parities
    of (C + 1)·ib: every CTA's dots and row j), group partials, taus and two
    scalars; when resident also the slab
    (max(rpc, ib) × (ib+1): it holds G while Tb is built), Tb (ib × (ib+1))
    and the work buffer."""
    rpc = -(-rows // ctas)
    pow2 = 1
    while 2 * pow2 < ib:
        pow2 *= 2
    ycols = max(CL_CW, pow2, -(-nb // ctas))
    small = CL_GK * (CL_GI + CL_GJ) + 2 * (ctas + 1) * ib + max(ib, CL_THREADS) + ib + 2
    big = max(rpc, ib) * (ib + 1) + ib * (ib + 1) + ib * ycols
    return 4 * (small + (big if resident else 0))


def cluster_plan(nb: int, rows: int, ib: int, rows_per_cta: Optional[int] = None) -> ClusterPlan:
    """The cluster of a K1/K2 launch whose largest couple has ``rows`` rows
    (K1: 2·nb, or nb with no couples; K2: nb + block_rows): the fewest CTAs
    that hold at most ``rows_per_cta`` rows each (ROWS_PER_CTA by default,
    16 CTAs at most), grown while the active block does not fit one CTA's
    shared memory; where it fits at no size, the smallest such cluster with
    the block in a global workspace."""
    if nb < 1 or ib < 1 or rows < nb:
        raise ValueError(f"cluster_plan: nb={nb}, rows={rows}, ib={ib}")
    target = ROWS_PER_CTA if rows_per_cta is None else rows_per_cta
    fits = [c for c in CLUSTER_SIZES if -(-rows // c) <= target]
    c0 = fits[0] if fits else CLUSTER_SIZES[-1]
    for c in CLUSTER_SIZES[CLUSTER_SIZES.index(c0):]:
        smem = cluster_smem_bytes(nb, rows, ib, c, True)
        if smem <= SMEM_LIMIT:
            return ClusterPlan(c, smem, True, -(-rows // c))
    return ClusterPlan(c0, cluster_smem_bytes(nb, rows, ib, c0, False), False, -(-rows // c0))


# live rows a CTA the TTQRT plan aims at (its largest block's set of
# nb + ib rows over C CTAs): 8 CTAs at nb = 256, ib = 128
TTQRT_ROWS_PER_CTA = 48


def ttqrt_rows(nb: int, ib: int) -> int:
    """Live rows of a TTQRT couple's largest block (``geqrt_cluster.cuh``:
    ``tri_rows_max``): R1's ib rows of the block and R2's rows above its
    end, nb + min(ib, nb)."""
    return nb + min(ib, nb)


def ttqrt_plan(nb: int, ib: int) -> ClusterPlan:
    """The cluster of a TTQRT launch (``csrc/ttqrt.cu``, the cluster routine
    on each block's live rows), ib ≤ nb: C from the largest live set,
    ``ttqrt_rows(nb, ib)`` rows, at TTQRT_ROWS_PER_CTA rows a CTA."""
    if nb < 1 or ib < 1 or ib > nb:
        raise ValueError(f"ttqrt_plan: nb={nb}, ib={ib}")
    return cluster_plan(nb, ttqrt_rows(nb, ib), ib, TTQRT_ROWS_PER_CTA)


def _cluster_args(nb: int, rows: int, ib: int, kw) -> tuple:
    """(library, work tensor, ctas, smem bytes, resident) of a K1/K2 launch;
    the plan first, so a bad geometry raises before the library loads."""
    plan = cluster_plan(nb, rows, ib)
    lib = _build.lib()
    work = torch.empty(lib.tq_cluster_work_floats(nb, rows, ib, plan.ctas, int(plan.resident)),
                       **kw)
    return lib, work, plan.ctas, plan.smem_bytes, int(plan.resident)


def _steps(a: torch.Tensor, k: int, nb: int, n_couples: Optional[int]) -> int:
    m, n = a.shape
    if m % nb or n % nb or k < 0 or (k + 1) * nb > min(m, n):
        raise ValueError(f"panel {k} with nb={nb} does not fit A of shape {tuple(a.shape)}")
    steps = (m // nb - k) if n_couples is None else 1 + n_couples
    if steps < 1 or (k + steps) * nb > m:
        raise ValueError(f"n_couples={n_couples} runs past the last row tile")
    return steps


def panel_factor_plain(a: torch.Tensor, k: int, nb: int, ib: int = 128,
                       n_couples: Optional[int] = None, counter: str = "panel_factor"):
    """Plain torch K1, the same algebra step by step."""
    _build.PLAIN_CALLS[counter] += 1
    steps = _steps(a, k, nb, n_couples)
    kw = dict(dtype=a.dtype, device=a.device)
    v_stack = torch.empty((steps, nb, nb), **kw)
    t2_stack = torch.empty((steps, nb, nb), **kw)
    r = torch.zeros((nb, nb), **kw)
    t_geqrt = None
    for i in range(steps):
        tile = a[(k + i) * nb : (k + i + 1) * nb, k * nb : (k + 1) * nb]
        at = torch.zeros((nb, 2 * nb), **kw)
        if i == 0:
            at[:, :nb] = tile.T
        else:
            at[:, :nb] = r.T
            at[:, nb:] = tile.T
        tt = torch.zeros((nb, nb), **kw)
        geqrt_in_place(at, tt, nb, ib)
        r = triu(at[:, :nb].T).contiguous()
        if i == 0:
            v_stack[0] = at[:, :nb].T
            t_geqrt = tt.T.contiguous()
            t2_stack[0] = 0
        else:
            v_stack[i] = at[:, nb:].T
            t2_stack[i] = tt.T
    return r, v_stack, t_geqrt, t2_stack


def panel_factor(a: torch.Tensor, k: int, nb: int, ib: int = 128,
                 n_couples: Optional[int] = None,
                 counter: str = "panel_factor") -> Tuple[torch.Tensor, ...]:
    """Factor panel column k of A: GEQRT on tile (k, k) plus TSQRT over the
    next ``n_couples`` sub-diagonal tiles (default: the whole column).

    Returns (r_kk, v_stack, t_geqrt, t2_stack): v_stack (1+n_couples, nb, nb)
    holds the packed GEQRT tile at slot 0 and the dense V2 tiles after it;
    t2_stack slot 0 is zero. ``counter``: the name the call counts under.
    """
    if not _build.is_cuda(a):
        return panel_factor_plain(a, k, nb, ib, n_couples, counter)
    _build.require_fp32(a)
    _build.require_row_major(a=a)
    steps = _steps(a, k, nb, n_couples)
    kw = dict(dtype=a.dtype, device=a.device)
    r = torch.empty((nb, nb), **kw)
    v_stack = torch.empty((steps, nb, nb), **kw)
    t_geqrt = torch.empty((nb, nb), **kw)
    t2_stack = torch.empty((steps, nb, nb), **kw)
    lib, work, ctas, smem, resident = _cluster_args(nb, 2 * nb if steps > 1 else nb, ib, kw)
    rc = lib.tq_panel_factor(
        a.data_ptr(), a.stride(0), k, nb, ib, steps - 1,
        r.data_ptr(), v_stack.data_ptr(), t_geqrt.data_ptr(), t2_stack.data_ptr(),
        work.data_ptr(), ctas, smem, resident, _build.stream(),
    )
    _build.check(rc, "panel_factor")
    _build.LAUNCHES[counter] += 1
    return r, v_stack, t_geqrt, t2_stack


def panel_head(pcol: torch.Tensor, row_off_blk: int, n_head: int, v_heads: torch.Tensor,
               t2_heads: torch.Tensor, head_base: int, nb: int,
               ib: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded driver's panel head (B13,
    ``tileqr/drivers/sharded_dyn.py:_panel_head_sh``): K1 on tile rows
    [row_off_blk, row_off_blk + 1 + n_head) of the panel-column stack pcol
    (rows, nb), with its GEQRT tile and head V2s written into the flat
    buffer v_heads, and its T2s (zero at the GEQRT slot) into t2_heads, at
    slots [head_base, head_base + 1 + n_head). Returns (r, t_geqrt)."""
    view = pcol[row_off_blk * nb : (row_off_blk + 1 + n_head) * nb]
    r, v_stack, t_geqrt, t2_stack = panel_factor(view, 0, nb, ib, n_couples=n_head,
                                                 counter="panel_head")
    v_heads[head_base : head_base + 1 + n_head] = v_stack
    t2_heads[head_base : head_base + 1 + n_head] = t2_stack
    return r, t_geqrt

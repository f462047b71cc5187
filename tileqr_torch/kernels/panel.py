"""Panel-column factorization K1: GEQRT plus the TSQRT head couples.

Counterpart of ``tileqr/kernels/panel.py:panel_factor``. Step 0 runs GEQRT
on tile (k, k); steps i ≥ 1 run TSQRT on the couple [R; A(k+i, k)], with R
carried from step to step. On a CUDA tensor the wrapper launches the CUDA
kernel ``tq_panel_factor`` (``csrc/panel.cu``); on a CPU tensor it runs the
plain version below. A is read only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import triu
from tileqr_torch.kernels.geqrt import geqrt_in_place


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
    lib = _build.lib()
    work = torch.empty(lib.tq_geqrt_work_floats(nb, nb, ib), **kw)
    rc = lib.tq_panel_factor(
        a.data_ptr(), a.stride(0), k, nb, ib, steps - 1,
        r.data_ptr(), v_stack.data_ptr(), t_geqrt.data_ptr(), t2_stack.data_ptr(),
        work.data_ptr(), _build.stream(),
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

"""Panel-column factorization K1: GEQRT plus the TSQRT head couples.

Counterpart of ``tileqr/kernels/panel.py:panel_factor``. Step 0 runs GEQRT
on tile (k, k); steps i ≥ 1 run TSQRT on the couple [R; A(k+i, k)], with R
carried from step to step. On a CUDA tensor the wrapper launches the CUDA
kernel ``tq_panel_factor`` (``csrc/panel.cu``); on a CPU tensor it runs the
plain version below. A is read only.

K1 and K2 (``kernels/chain.py``) run as one thread-block cluster a launch
(``csrc/geqrt_cluster.cuh``); ``geqrt.cluster_plan`` picks its size and
where the active block lives, and the launch is given its numbers. A launch of
two or more steps runs them pipelined by ib block (``pipeline_plan``,
``csrc/panel_pipe.cuh``): q = nb / ib clusters, cluster s factoring block
s of every couple in turn, beside cluster s - 1 on the next couple, each
over the rows its block can change (``stage_rows``; a K2 launch's first
couple whole). The R carried from couple to couple is upper triangular, and
K2 is given r_in's upper triangle, pipelined or not (tileqr's K2 walks a
full r_in's strict lower part too; no driver passes an r_in that has one).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import triu
from tileqr_torch.kernels.geqrt import ClusterPlan, cluster_plan, geqrt_in_place


class PipelinePlan(NamedTuple):
    stages: int                          # q clusters, one an ib block; 1: the serial loop
    windows: Tuple[Tuple[int, int], ...]  # stage s: R's rows [s·ib, s·ib + ibk) it owns
    rows: int                            # the most rows a stage walks
    cluster: ClusterPlan                 # each stage's cluster (the serial loop's at 1)


def stage_rows(nb: int, ib: int, s: int, r_rows: int, b_rows: int, full: bool) -> int:
    """Rows that stage s walks in a couple of ``r_rows`` R rows (0 or nb)
    over ``b_rows`` B rows (``geqrt_cluster.cuh``: ``PipeRows``): a full
    couple (the GEQRT tile, or a K2 launch's first couple) every row from
    s·ib on, a TS couple R's rows of block s and every B row."""
    ibk = min(ib, nb - s * ib)
    return r_rows + b_rows - s * ib if full else ibk + b_rows


def pipeline_plan(nb: int, ib: int, steps: int, rows: int,
                  full_first: bool = False) -> PipelinePlan:
    """The pipelined launch of a chain of ``steps`` couples whose largest
    has ``rows`` rows (K1: 2·nb; K2, and K1 with K2: nb + block_rows): q =
    ceil(nb / ib) stages, stage s owning R's rows [s·ib, s·ib + ibk), each
    a cluster from ``cluster_plan`` at the most rows a stage walks (a TS
    couple's ib + rows − nb, the GEQRT tile's nb, and with ``full_first``,
    a K2 launch's first couple walked whole, ``rows``). One step or q = 1:
    the serial loop (stages 1, today's cluster at ``rows``)."""
    if nb < 1 or ib < 1 or steps < 1 or rows < nb:
        raise ValueError(f"pipeline_plan: nb={nb}, ib={ib}, steps={steps}, rows={rows}")
    q = -(-nb // ib)
    if steps < 2 or q < 2:
        return PipelinePlan(1, ((0, nb),), rows, cluster_plan(nb, rows, ib))
    windows = tuple((s * ib, min(nb, (s + 1) * ib)) for s in range(q))
    walk = max(nb, stage_rows(nb, ib, 0, nb, rows - nb, False))
    if full_first:
        walk = max(walk, rows)
    return PipelinePlan(q, windows, walk, cluster_plan(nb, walk, ib))


# the hand-off buffer of each (device, stream) and the epoch of its last
# launch (csrc/panel_pipe.cuh): the flags hold epochs, so it is never cleared
_SYNC: dict = {}
_SYNC_LOCK = threading.Lock()
_EPOCH_LIMIT = 1 << 31


def _pipelined(nb: int, ib: int, steps: int, rows: int,
               full_first: bool = False) -> Optional[PipelinePlan]:
    """The plan of a pipelined launch, or None where the serial loop runs:
    one step, q = 1, or while the stream is captured in a CUDA graph (a
    replay would reuse the launch's epoch, whose tickets are taken)."""
    plan = pipeline_plan(nb, ib, steps, rows, full_first)
    if plan.stages == 1 or (torch.cuda.is_available()
                            and torch.cuda.is_current_stream_capturing()):
        return None
    return plan


def _sync_buffer(device: torch.device, words: int) -> Tuple[torch.Tensor, int]:
    """The hand-off buffer of the current stream (at least ``words`` words)
    and this launch's epoch."""
    key = (device.index, _build.stream())
    with _SYNC_LOCK:  # two threads on one stream take two epochs
        ent = _SYNC.get(key)
        if ent is None or ent[0].numel() < words or ent[1] + 1 >= _EPOCH_LIMIT:
            ent = _SYNC[key] = [torch.zeros(max(words, 1024), dtype=torch.int64, device=device),
                                0]
        ent[1] += 1
        return ent[0], ent[1]


def launch_pipelined(plan: PipelinePlan, a: torch.Tensor, k: int, nb: int, ib: int, geqrt: int,
                     n_head: int, n_chunks: int, block_rows: int, chunk_row0: int,
                     r_in: Optional[torch.Tensor], r_out: torch.Tensor, k1_out: tuple,
                     k2_out: tuple) -> None:
    """One pipelined launch (``tq_panel_pipe``): with ``geqrt`` the GEQRT of
    tile (k, k), n_head head couples, then n_chunks chunk couples; without,
    K2's chunk couples after r_in (upper triangular). k1_out (v_stack,
    t_geqrt, t2_stack) and k2_out (v_chunks, t2_chunks), None where the
    launch has none."""
    lib = _build.lib()
    c = plan.cluster
    steps = geqrt + n_head + n_chunks
    kw = dict(dtype=a.dtype, device=a.device)
    work = torch.empty(plan.stages * lib.tq_cluster_work_floats(nb, plan.rows, ib, c.ctas,
                                                                int(c.resident)), **kw)
    sync, epoch = _sync_buffer(a.device, 1 + steps * plan.stages)
    v_stack, t_geqrt, t2_stack = k1_out
    v_chunks, t2_chunks = k2_out
    rc = lib.tq_panel_pipe(
        a.data_ptr(), a.stride(0), k, nb, ib, plan.rows, geqrt, n_head, n_chunks, block_rows,
        chunk_row0, _build.ptr(r_in), r_out.data_ptr(), _build.ptr(v_stack),
        _build.ptr(t_geqrt), _build.ptr(t2_stack), _build.ptr(v_chunks), _build.ptr(t2_chunks),
        work.data_ptr(), sync.data_ptr(), epoch, plan.stages, c.ctas, c.smem_bytes,
        int(c.resident), _build.stream(),
    )
    _build.check(rc, "panel_pipe")
    _build.PIPELINE["launches"] += 1
    _build.PIPELINE["overlapped_steps"] += steps - 1
    _build.count_exchange(c.ctas, steps * nb)  # stage s walks block s of every step


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
    rows = 2 * nb if steps > 1 else nb
    plan = _pipelined(nb, ib, steps, rows)
    r = torch.empty((nb, nb), **kw)
    v_stack = torch.empty((steps, nb, nb), **kw)
    t_geqrt = torch.empty((nb, nb), **kw)
    t2_stack = torch.empty((steps, nb, nb), **kw)
    if plan is not None:
        launch_pipelined(plan, a, k, nb, ib, 1, steps - 1, 0, 0, 0, None, r,
                         (v_stack, t_geqrt, t2_stack), (None, None))
    else:
        lib, work, ctas, smem, resident = _cluster_args(nb, rows, ib, kw)
        rc = lib.tq_panel_factor(
            a.data_ptr(), a.stride(0), k, nb, ib, steps - 1,
            r.data_ptr(), v_stack.data_ptr(), t_geqrt.data_ptr(), t2_stack.data_ptr(),
            work.data_ptr(), ctas, smem, resident, _build.stream(),
        )
        _build.check(rc, "panel_factor")
        _build.count_exchange(ctas, steps * nb)
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

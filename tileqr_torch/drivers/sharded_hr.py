"""2D block-cyclic sharded QR with CholeskyQR2 panels and Householder
reconstruction (``qr_sharded`` with ``QRConfig(square_method="hr")``;
counterpart of ``tileqr/drivers/sharded_hr.py``).

Every rank of a pr × pc ``Mesh`` calls the driver with the same global A
and keeps its block-cyclic tiles as one local matrix (no dummy tiles: A is
padded to nb·pr × nb·pc by ``pad_for_hr``, the columns with α). Per panel
k, on rank (r, c), every matmul in IEEE fp32 (``_highest``) but the
update's, which follows the precision mode:

1. the panel column, broadcast along 'cols' from mesh column k % pc
   (tileqr's masked psum), with the rows above the panel's window zeroed
   (``wmask``: the row mask takes the place of window shapes);
2. ``_cholqr2_psum``: G = psum_rows(PᵀP), POTRF (B9) and the triangular
   inverse replicated, Q₁ = P·S₁ local, E = psum_rows(Q₁ᵀQ₁) − I, the
   matmul-only second round, R = triu(Wᵀ·S₁ᵀ·G);
3. ``_reconstruct_yt_dist``: the diagonal owner's Q₁ top block broadcast
   over 'rows', the modified LU (B8) replicated, Y = Q₁·(W·U⁻¹) local with
   L1 in the owner's top block, T = −U·diag(d)·L1⁻ᵀ;
4. ``_apply_panel_dist``: C ← (I − Y·T·Yᵀ)ᵀ·C on the segment's slice, with
   one psum over 'rows' of the projection W = YᵀC between the two local
   halves (B7a ``panel_project`` and B7b ``panel_sub`` in the emulated
   modes, tileqr's plain torch routes in "highest").

Per panel that is one column broadcast, two nb² sums, one nb² broadcast
and one sum of the nb-row W strip: no ppermute and no tree.

ONE host loop over panels stands for tileqr's ``fori_loop`` inside
``shard_map``; offsets are integers. tileqr's segments (``_seg_table``)
bound its compile, and the port keeps them all the same: each segment
updates the slice ``loc[lr·nb:, lc·nb:]`` of the local matrix, and
``_apply_panel_dist`` picks its route from the slice's local row and
column counts, so the slicing sets the values.

The guard is the api's (``api.qr_sharded``): ``health`` is the max over
panels of the round-1 defect, replicated, as on the single card.
Conditioning contract: cond(A) ≲ 1e3 in fp32, as ``drivers/square_hr.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tileqr_torch.core.layout import round_up
from tileqr_torch.dist.mesh import Mesh
from tileqr_torch.drivers.cholqr import (
    _correction,
    _defect,
    _highest,
    _triu_inv_doubling,
    bdot_pair_rows,
)
from tileqr_torch.drivers.sharded import _check_mesh, _local_block, _unpack, assemble_r_sharded
from tileqr_torch.drivers.square_hr import _W_PAIR_MAX_COLS, _w_splitk, pad_for_hr
from tileqr_torch.kernels.common import (
    counter_key,
    dot_bx,
    passes_of,
    split_bf16,
    split_bf16_trunc,
)
from tileqr_torch.kernels.modlu import modified_lu
from tileqr_torch.kernels.panel_apply import panel_project, panel_sub
from tileqr_torch.kernels.potrf import potrf_batched

# tileqr's default segment count (``qr_sharded_factor_hr(segments=8)``)
SEGMENTS = 8


class ShardedHRFactors(NamedTuple):
    """One rank's slice of tileqr's ``ShardedHRFactors``.

    local: (lm, ln) updated local matrix (R's tiles in place, junk below
    the diagonal); r_diag, t_all: (k_max, nb, nb) final diagonal R tiles
    and the T factors (replicated); y_segs: per segment (ke − ks, lm_s, nb),
    panel k's local Y rows over the segment's slice (zero above the
    panel's window); segs: ((ks, ke, lr, lc), …) from ``_seg_table``;
    health: the max round-1 defect over the panels (0-d, replicated);
    coords: the rank's mesh position."""

    local: torch.Tensor
    r_diag: torch.Tensor
    t_all: torch.Tensor
    y_segs: Tuple[torch.Tensor, ...]
    nb: int
    shape: Tuple[int, int]
    grid: Tuple[int, int, int, int]  # (mt, nt, pr, pc)
    segs: Tuple[Tuple[int, int, int, int], ...]
    health: Optional[torch.Tensor] = None
    coords: Tuple[int, int] = (0, 0)


def _seg_table(k_max: int, pr: int, pc: int, segments: int):
    """Segment boundaries + per-segment static local row/col tile starts.

    Segment s covers panels [ks, ke). Its local slice must contain every
    row/col tile any device still needs at panel ks: global tile ≥ ks maps
    to local tile ≥ (ks − (p−1)) // p on the furthest-ahead device — the
    conservative start; the window mask absorbs the ≤1-tile raggedness."""
    segments = max(1, min(segments, k_max))
    bounds = [round(s * k_max / segments) for s in range(segments + 1)]
    segs = []
    for s in range(segments):
        ks, ke = bounds[s], bounds[s + 1]
        if ks == ke:
            continue
        lr = max(0, ks - (pr - 1)) // pr
        lc = max(0, ks - (pc - 1)) // pc
        segs.append((ks, ke, lr, lc))
    return tuple(segs)


def _cholqr2_psum(p: torch.Tensor, mesh: Mesh):
    """Distributed CholeskyQR2 of one panel (rows sharded over 'rows',
    zeros outside the window): (Q₁ local rows, W, R, defect), the last
    three replicated. Q is never formed: W folds into what is applied to
    Q₁."""
    nb = p.shape[1]
    eye = torch.eye(nb, dtype=p.dtype, device=p.device)
    g = mesh.psum(bdot_pair_rows(p[None], p[None])[0].contiguous(), "rows")
    r1 = potrf_batched(g[None])
    s1 = _triu_inv_doubling(r1)[0]
    q1 = p @ s1
    # the correction gram must see Q₁'s rounding: one more nb² sum
    e = mesh.psum(bdot_pair_rows(q1[None], q1[None])[0].contiguous(), "rows") - eye
    w = _correction(e[None])[0]
    r = torch.triu(w.T @ (s1.T @ g))
    return q1, w, r, _defect(e)


def _reconstruct_yt_dist(q1: torch.Tensor, w: torch.Tensor, lu: torch.Tensor,
                         d: torch.Tensor, top_off: int, is_owner: bool):
    """(Y local rows, T) from Q₁, W and the top block's modified LU: the two
    triangular inverses as one B = 2 doubling batch, Y = Q₁·(W·U⁻¹), then
    the owner's top block overwritten with the LU's exact L1."""
    nb = lu.shape[0]
    l1 = torch.tril(lu, -1) + torch.eye(nb, dtype=lu.dtype, device=lu.device)
    u = torch.triu(lu)
    invs = _triu_inv_doubling(torch.stack([u, l1.T]))
    uinv, l1tinv = invs[0], invs[1]
    t = -((u * d[None, :]) @ l1tinv)
    y = q1 @ (w @ uinv)
    if is_owner:
        y[top_off : top_off + nb] = l1
    return y, t


def _kernel_route(precision: str, dtype: torch.dtype, m: int, n: int, nb: int) -> bool:
    """Whether a (m, n) target takes B7's halves: float32, nb-aligned and
    not empty, in an emulated mode. tileqr sends only b3/b4 there; the
    port sends every emulated mode, as its single-card hr apply does, so
    "high" is b3 bitwise. "highest" keeps tileqr's plain routes: on the
    card their fp32 ``apply_q_sharded`` relerr at 16384² on 4×2 is under
    1e-6 (PERF.md §6), so B7's fp32 halves are not needed there."""
    if dtype != torch.float32 or n == 0 or m % nb or n % nb:
        return False
    return passes_of(precision) > 0


def _apply_panel_halves(y: torch.Tensor, t: torch.Tensor, c: torch.Tensor, mesh: Mesh,
                        precision: str, trans: bool) -> torch.Tensor:
    """The kernel route: W = B7a(Y, C) summed over 'rows', op(T)·W in fp32,
    then B7b: C −= Y·W in place."""
    tm = t.T if trans else t
    w = mesh.psum(panel_project(y, c, precision), "rows")
    return panel_sub(y, (tm @ w).contiguous(), c, precision)


def _apply_panel_dist(y: torch.Tensor, t: torch.Tensor, c: torch.Tensor, mesh: Mesh,
                      precision: str, trans: bool) -> torch.Tensor:
    """C ← (I − Y·T·Yᵀ)ᵀ C (trans) or (I − Y·T·Yᵀ) C over sharded rows, in
    place on the view c: one psum over 'rows' of the projection W = YᵀC,
    op(T)·W, C −= Y·W; by B7's halves on ``_kernel_route``'s targets,
    elsewhere by ``_apply_panel_torch``."""
    route = _kernel_route(precision, c.dtype, y.shape[0], c.shape[1], y.shape[1])
    return (_apply_panel_halves if route else _apply_panel_torch)(y, t, c, mesh, precision,
                                                                   trans)


def _apply_panel_torch(y: torch.Tensor, t: torch.Tensor, c: torch.Tensor, mesh: Mesh,
                       precision: str, trans: bool) -> torch.Tensor:
    """tileqr's plain routes of the same update, in torch: in an emulated
    mode on float32 the three products split (b3/b4 with tileqr's
    truncating split, "high"/"default" rounding to nearest as the TPU's
    HIGH/DEFAULT); else W pairwise at ≥ 2048 local rows and ≤
    ``_W_PAIR_MAX_COLS`` columns, split-K at ≥ 4096 rows in float32, one
    product otherwise (tileqr takes neither for b3/b4, whose float64
    products are exact)."""
    m = y.shape[0]
    n = c.shape[1]
    tm = t.T if trans else t
    passes = passes_of(precision)
    if passes and c.dtype == torch.float32:
        split = split_bf16_trunc if precision in ("b3", "b4") else split_bf16
        w = mesh.psum(dot_bx(y.T, c, passes, split), "rows")
        c -= dot_bx(y, dot_bx(tm, w, passes, split), passes, split)
        return c
    exact = precision in ("b3", "b4")
    if not exact and m >= 2048 and n <= _W_PAIR_MAX_COLS:
        w = bdot_pair_rows(y[None], c[None])[0]
    elif not exact and c.dtype == torch.float32 and m >= 4096:
        w = _w_splitk(y, c)
    else:
        w = y.T @ c
    w = mesh.psum(w.contiguous(), "rows")
    c -= y @ (tm @ w)
    return c


def planned_launches_hr(grid: Tuple[int, int, int, int], nb: int, precision: str = "highest",
                        segments: int = SEGMENTS, cols: Optional[int] = None) -> dict:
    """Kernel launches on one rank, from the geometry alone: of one
    ``qr_sharded_factor_hr`` (B9 and B8 on every panel; B7a and B7b, in
    the mode, on every panel whose segment slice takes the kernel route:
    all of them in an emulated mode, none in "highest"), or with ``cols``
    of one ``apply_q_sharded_hr`` to a C whose local matrix has that many
    columns (the halves only)."""
    mt, nt, pr, pc = grid
    k_max = min(mt, nt)
    lm, ln = (mt // pr) * nb, (nt // pc) * nb
    halves = (counter_key("panel_project", precision), counter_key("panel_sub", precision))
    out = dict.fromkeys(halves, 0)
    if cols is None:
        out.update(potrf_batched=k_max, modified_lu=k_max)
    for ks, ke, lr, lc in _seg_table(k_max, pr, pc, segments):
        width = ln - lc * nb if cols is None else cols
        if _kernel_route(precision, torch.float32, lm - lr * nb, width, nb):
            for h in halves:
                out[h] += ke - ks
    return out


def qr_sharded_factor_hr(a: torch.Tensor, mesh: Mesh, nb: int, precision: str = "highest",
                         segments: int = SEGMENTS) -> ShardedHRFactors:
    """Factor the global A (M, N), the same tensor on every rank, across
    the mesh; returns this rank's ShardedHRFactors."""
    pr, pc = mesh.shape
    r, col = mesh.r, mesh.c
    m, n = a.shape
    ap, _ = pad_for_hr(a, nb, row_mult=nb * pr, col_mult=nb * pc)
    mt, nt = ap.shape[0] // nb, ap.shape[1] // nb
    k_max = min(mt, nt)
    loc = _local_block(ap, nb, pr, pc, r, col).contiguous()
    del ap
    segs = _seg_table(k_max, pr, pc, segments)
    r_diag = a.new_zeros((k_max, nb, nb))
    t_all = a.new_zeros((k_max, nb, nb))
    health = a.new_zeros(())
    y_segs = []
    with _highest():
        for ks, ke, lr, lc in segs:
            sub = loc[lr * nb :, lc * nb :]
            lm_s = sub.shape[0]
            rowg = (torch.arange(lm_s, device=a.device) // nb + lr) * pr + r
            y_seg = a.new_zeros((ke - ks, lm_s, nb))
            for k in range(ks, ke):
                r_k, c_k = k % pr, k % pc
                top_off = (k // pr - lr) * nb

                # 1. the panel column along 'cols', masked to the window
                if col == c_k:
                    lk = (k // pc - lc) * nb
                    pcol = sub[:, lk : lk + nb].contiguous()
                else:
                    pcol = a.new_empty((lm_s, nb))
                mesh.broadcast(pcol, c_k, "cols")
                wmask = (rowg >= k).to(a.dtype)[:, None]
                p = pcol * wmask

                # 2. CholeskyQR2 over the mesh rows
                q1, wc, rch, emax = _cholqr2_psum(p, mesh)
                health = torch.maximum(health, emax)

                # 3. the reconstruction: the owner's top block, B8 replicated
                if r == r_k:
                    q1top = q1[top_off : top_off + nb].contiguous()
                else:
                    q1top = a.new_empty((nb, nb))
                mesh.broadcast(q1top, r_k, "rows")
                lu, d = modified_lu(q1top @ wc)
                y, t = _reconstruct_yt_dist(q1, wc, lu, d, top_off, r == r_k)
                y = y * wmask

                # 4. the update of the segment's slice, in the mode
                _apply_panel_dist(y, t, sub, mesh, precision, trans=True)

                r_diag[k] = d[:, None] * rch
                y_seg[k - ks] = y
                t_all[k] = t
            y_segs.append(y_seg)
    return ShardedHRFactors(loc, r_diag, t_all, tuple(y_segs), nb, (m, n),
                            (mt, nt, pr, pc), segs, health, (r, col))


# R is the triu of the local matrices with the diagonal tiles replaced, as
# for the Householder factors (tileqr's hr driver reuses its dynamic
# driver's assemble); the hr local matrix has no dummy tiles to drop
assemble_r_sharded_hr = assemble_r_sharded


def apply_q_sharded_hr(f: ShardedHRFactors, c_mat: torch.Tensor, mesh: Mesh,
                       trans: bool = True, precision: str = "highest") -> torch.Tensor:
    """C ← Qᵀ·C (trans) or Q·C, on every rank: C (M, P) is the same global
    matrix on every rank; the factor's update replays segment by segment
    on C's block-cyclic local matrix, Qᵀ with the segments and panels
    forward, Q with both reversed."""
    _check_mesh(f, mesh)
    nb = f.nb
    mt, _, pr, pc = f.grid
    mc, p = c_mat.shape
    if mc != f.shape[0]:
        raise ValueError(f"c rows {mc} != M {f.shape[0]}")
    ppad = round_up(max(p, 1), nb * pc)
    cp = torch.nn.functional.pad(c_mat, (0, ppad - p, 0, mt * nb - mc))
    cm = _local_block(cp, nb, pr, pc, mesh.r, mesh.c).contiguous()
    del cp
    order = range(len(f.segs)) if trans else reversed(range(len(f.segs)))
    with _highest():
        for si in order:
            ks, ke, lr, _ = f.segs[si]
            sub = cm[lr * nb :]
            panels = range(ks, ke) if trans else reversed(range(ks, ke))
            for k in panels:
                _apply_panel_dist(f.y_segs[si][k - ks], f.t_all[k], sub, mesh, precision, trans)
    return _unpack(mesh, cm, nb)[:mc, :p]

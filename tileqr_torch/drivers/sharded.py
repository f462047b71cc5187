"""2D block-cyclic sharded tiled QR on a process grid (counterpart of
``tileqr/drivers/sharded.py`` and ``sharded_dyn.py``, the Householder
sharded drivers).

Every rank of a pr × pc ``Mesh`` (``dist/mesh.py``) calls the driver with
the same global A, as tileqr's ``shard_map`` body sees it, and keeps its
block-cyclic tiles: tile (i, j) of the (Mt, Nt) tile grid lives on rank
(i % pr, j % pc), which stores its tiles as one local matrix with two zero
dummy tile columns on the right and dummy tile rows at the bottom up to a
chunk multiple (``_row_pad_tiles``). Zero tiles flow through every kernel
as tau = 0 no-ops and stay zero.

ONE driver stands for tileqr's two: a host loop over panels that follows
``qr_sharded_factor_dyn``'s phases, the offsets passed to K1-K4 as
integers. ``chunk`` is the height of the local sub-diagonal couples in
tiles; at chunk 1 the couples are single tiles, the algebra and couple
order of tileqr's static driver (``couple_apply``, B14), so the sharded
entry (``api.qr_sharded``) picks the chunk by tileqr's driver rule. Per
panel k, on rank (r, c):

1. the panel column's rows from the rank's window down, broadcast along
   'cols' from mesh column k % pc (tileqr's masked psum);
2. the local chain: K1 (GEQRT + the unaligned head couples, B13
   ``panel_head``) and K2 over the chunk couples, into flat factor
   buffers at tileqr's slots;
3. the TTQRT tree over 'rows', rotated so that its root is the diagonal
   owner k % pr: only the root side of each level combines, by the TTQRT
   kernel (B15), and keeps triu of the new R;
4. the root's R broadcast to every rank as ``r_diag[k]``;
5. K4/K3 on the rank's row strip from the panel's first trailing column;
6. the strip tree: the leaf side sends its strip down, the root side
   applies the level's reflectors by K3 with one couple (``ttmqr``), and
   sends the new bottom back up to the leaf.

The trees exchange only the strip's columns from the trailing window on:
tileqr's full-width strips carry stale sub-diagonal storage to the left,
which nothing reads. The tree slots of ranks that were not at a level's
root side stay zero (tileqr fills them with factors no one reads).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from tileqr_torch.core.layout import round_up
from tileqr_torch.dist.mesh import Mesh
from tileqr_torch.kernels.chain import couple_strip, larfb_strip, panel_chain
from tileqr_torch.kernels.panel import panel_head
from tileqr_torch.kernels.ttqrt import ttmqr, ttqrt


class ShardedFactors(NamedTuple):
    """One rank's slice of tileqr's ``ShardedDynFactors`` (flat buffers).

    local: (lm_pad, ln_pad) updated local matrix (dummy tile rows/columns
    of padding); r_diag: (k_max, nb, nb) final diagonal R tiles
    (replicated); v_heads/t2_heads: (k_max·c, nb, nb), panel k's packed
    GEQRT tile at slot k·c and its head V2/T2 tiles after it; tg_all:
    (k_max, nb, nb) GEQRT T; v_chunks: (total_c, c·nb, nb) and t2_chunks
    (total_c, nb, nb) chunk-couple factors at ``_chunk_bases_sh``'s slots;
    tree_v2/tree_t2: (k_max, levels, nb, nb) TTQRT factors (zero where the
    rank was not at the root side). coords: the rank's mesh position."""

    local: torch.Tensor
    r_diag: torch.Tensor
    v_heads: torch.Tensor
    tg_all: torch.Tensor
    t2_heads: torch.Tensor
    v_chunks: torch.Tensor
    t2_chunks: torch.Tensor
    tree_v2: torch.Tensor
    tree_t2: torch.Tensor
    nb: int
    chunk: int
    shape: Tuple[int, int]  # original (M, N)
    grid: Tuple[int, int, int, int]  # (mt, nt, pr, pc)
    coords: Tuple[int, int]  # (r, c)


# ---- layout (copies of tileqr's helpers, on host integers) ----

def _to_local_layout(a: torch.Tensor, nb: int, pr: int, pc: int) -> torch.Tensor:
    """(M, N) → (pr, pc, lm, ln): block-cyclic local matrices with tile
    (i, j) at local tile (i // pr, j // pc) of rank (i % pr, j % pc)."""
    m, n = a.shape
    mt, nt = m // nb, n // nb
    t = a.reshape(mt // pr, pr, nb, nt // pc, pc, nb).permute(1, 4, 0, 2, 3, 5)
    return t.reshape(pr, pc, (mt // pr) * nb, (nt // pc) * nb)


def _local_block(a: torch.Tensor, nb: int, pr: int, pc: int, r: int, c: int) -> torch.Tensor:
    """``_to_local_layout(a, nb, pr, pc)[r, c]`` without forming the other
    ranks' blocks."""
    m, n = a.shape
    mt, nt = m // nb, n // nb
    t = a.reshape(mt // pr, pr, nb, nt // pc, pc, nb)[:, r, :, :, c, :]
    return t.reshape((mt // pr) * nb, (nt // pc) * nb)


def _from_local_layout(t: torch.Tensor, nb: int) -> torch.Tensor:
    pr, pc, lm, ln = t.shape
    lmt, lnt = lm // nb, ln // nb
    t = t.reshape(pr, pc, lmt, nb, lnt, nb).permute(2, 0, 3, 4, 1, 5)
    return t.reshape(lmt * pr * nb, lnt * pc * nb)


def _tree_perms(pr: int, r_k: int):
    """Per tree level over the mesh rows, rotated so that rotated row
    t = (r − r_k) % pr = 0 is the root: (down pairs, up pairs, d); down
    sends t + d → t for t % 2d == 0, up reverses it."""
    levels = []
    d = 1
    while d < pr:
        down, up = [], []
        for t in range(0, pr, 2 * d):
            if t + d < pr:
                src = (t + d + r_k) % pr
                dst = (t + r_k) % pr
                down.append((src, dst))
                up.append((dst, src))
        levels.append((tuple(down), tuple(up), d))
        d *= 2
    return levels


def _roles(t_rot: int, d: int, pr: int) -> Tuple[bool, bool]:
    """(root side, leaf side) of rotated row t_rot at the level of width d."""
    return (t_rot % (2 * d) == 0 and t_rot + d < pr), t_rot % (2 * d) == d


def _row_pad_tiles(lmt: int, c: int) -> int:
    """Local tile-row extent with dummies: at least lmt + 2, rounded up so
    that chunks of c tiles tile the remainder for any alignment start."""
    return round_up(lmt + 2, c)


def _chunk_bases_sh(lmt_pad: int, pr: int, c: int, k_max: int) -> Tuple[List[int], int]:
    """Chunk-slot offsets: panel k uses at most (lmt_pad − (k//pr + 1)) // c
    chunk couples on any mesh row."""
    bases, acc = [], 0
    for k in range(k_max):
        bases.append(acc)
        acc += (lmt_pad - (k // pr + 1)) // c
    return bases, max(acc, 1)


def _local_geometry(k: int, r: int, lmt_pad: int, pr: int, c: int) -> Tuple[int, int, int, int]:
    """Panel k's window on mesh row r: (ls_blk: local tile row of the panel
    stack's top, n_head: unaligned head couples to the next c-aligned
    boundary, cstart: first chunk in units of c tiles, nch: chunk couples
    to the padded end)."""
    ls_blk = k // pr + (1 if r < k % pr else 0)
    n_head = (c - (ls_blk + 1) % c) % c
    align = ls_blk + 1 + n_head
    return ls_blk, n_head, align // c, (lmt_pad - align) // c


def _grid(m: int, n: int, nb: int, pr: int, pc: int, chunk: int):
    mt, nt = round_up(m, nb * pr) // nb, round_up(n, nb * pc) // nb
    lmt = mt // pr
    c = max(1, min(chunk, lmt))
    return mt, nt, c, _row_pad_tiles(lmt, c)


def planned_launches(grid: Tuple[int, int, int, int], chunk: int, r: int) -> dict:
    """Kernel launches of one ``qr_sharded_factor`` on mesh row r, from the
    geometry alone: K1 (every launch a ``panel_head``), K2, K3 (the local
    sweeps; the strip tree's as ``ssrfb``), K4 and TTQRT."""
    mt, nt, pr, _ = grid
    k_max = min(mt, nt)
    lmt_pad = _row_pad_tiles(mt // pr, chunk)
    out = dict.fromkeys(("panel_head", "panel_chain", "couple_strip", "larfb_strip",
                         "ttqrt", "ssrfb"), 0)
    for k in range(k_max):
        _, n_head, _, nch = _local_geometry(k, r, lmt_pad, pr, chunk)
        out["panel_head"] += 1
        out["panel_chain"] += nch > 0
        out["couple_strip"] += (n_head > 0) + (nch > 0)
        out["larfb_strip"] += n_head == 0 and nch == 0
        t_rot = (r - k % pr) % pr
        roots = sum(_roles(t_rot, d, pr)[0] for _, _, d in _tree_perms(pr, k % pr))
        out["ttqrt"] += roots
        out["ssrfb"] += roots
    return out


# ---- the panel phases shared by the factorization and the apply ----

def _sweep(mat, strip, f_bufs, k: int, geo, c: int, nb: int, col_start: int,
           trans: bool, precision: str) -> None:
    """K4/K3 of panel k on the row strip (a view of mat's row tile ls_blk
    from column tile col_start), in place: LARFB then the head and chunk
    couples (trans), or the reverse order (Q·C)."""
    v_heads, tg_all, t2_heads, v_chunks, t2_chunks, cb = f_bufs
    ls_blk, n_head, cstart, nch = geo
    hb = k * c
    vkk, tg = v_heads[hb], tg_all[k]
    heads = (v_heads, t2_heads, mat, strip, hb + 1, ls_blk + 1, n_head, nb, nb, col_start)
    chunks = (v_chunks, t2_chunks, mat, strip, cb, cstart, nch, c * nb, nb, col_start)
    if trans:
        if n_head > 0:
            couple_strip(*heads, trans=True, vkk=vkk, tg=tg, precision=precision)
            if nch > 0:
                couple_strip(*chunks, trans=True, precision=precision)
        elif nch > 0:
            couple_strip(*chunks, trans=True, vkk=vkk, tg=tg, precision=precision)
        else:
            larfb_strip(vkk, tg, strip, nb, trans=True, precision=precision)
        return
    if nch > 0:
        fuse = dict(vkk=vkk, tg=tg) if n_head == 0 else {}
        couple_strip(*chunks, trans=False, reverse=True, precision=precision, **fuse)
    if n_head > 0:
        couple_strip(*heads, trans=False, reverse=True, vkk=vkk, tg=tg, precision=precision)
    if n_head == 0 and nch == 0:
        larfb_strip(vkk, tg, strip, nb, trans=False, precision=precision)


def _strip_tree(mesh: Mesh, strip: torch.Tensor, tv: torch.Tensor, tt: torch.Tensor,
                r_k: int, trans: bool, precision: str) -> None:
    """The strip-level TTMQR tree over 'rows', in place on the strip: the
    factor and Qᵀ order when trans, reversed for Q·C."""
    levels = list(enumerate(_tree_perms(mesh.pr, r_k)))
    if not trans:
        levels = levels[::-1]
    t_rot = (mesh.r - r_k) % mesh.pr
    for li, (down, up, d) in levels:
        root, leaf = _roles(t_rot, d, mesh.pr)
        if root:
            recv = mesh.ppermute_rows(strip, down)
            top, bot = ttmqr(tv[li], tt[li], strip, recv, trans=trans, precision=precision)
            strip.copy_(top)
            mesh.ppermute_rows(bot, up)
        elif leaf:
            mesh.ppermute_rows(strip, down)
            strip.copy_(mesh.ppermute_rows(strip, up))


def qr_sharded_factor(a: torch.Tensor, mesh: Mesh, nb: int, ib: int = 128, chunk: int = 4,
                      precision: str = "highest") -> ShardedFactors:
    """Factor the global A (M, N), the same tensor on every rank, across
    the mesh; returns this rank's ShardedFactors. ``chunk`` is clamped to
    [1, local tile rows], as tileqr's dynamic driver does."""
    pr, pc = mesh.shape
    r, col = mesh.r, mesh.c
    m, n = a.shape
    mt, nt, c, lmt_pad = _grid(m, n, nb, pr, pc, chunk)
    k_max, lmt, lnt = min(mt, nt), mt // pr, nt // pc
    ap = torch.nn.functional.pad(a, (0, nt * nb - n, 0, mt * nb - m))
    loc = a.new_zeros((lmt_pad * nb, (lnt + 2) * nb))
    loc[: lmt * nb, : lnt * nb] = _local_block(ap, nb, pr, pc, r, col)
    del ap
    lm_pad = loc.shape[0]
    cbases, total_c = _chunk_bases_sh(lmt_pad, pr, c, k_max)
    n_lvl = max(len(_tree_perms(pr, 0)), 1)

    def zeros(*shape):
        return a.new_zeros(shape)

    r_diag, tg_all = zeros(k_max, nb, nb), zeros(k_max, nb, nb)
    v_heads, t2_heads = zeros(k_max * c, nb, nb), zeros(k_max * c, nb, nb)
    v_chunks, t2_chunks = zeros(total_c, c * nb, nb), zeros(total_c, nb, nb)
    tree_v2, tree_t2 = zeros(k_max, n_lvl, nb, nb), zeros(k_max, n_lvl, nb, nb)

    for k in range(k_max):
        r_k, c_k = k % pr, k % pc
        geo = _local_geometry(k, r, lmt_pad, pr, c)
        ls_blk, n_head, _, nch = geo
        cb = cbases[k]

        # 1. the panel column from the window down, along 'cols'
        lk = k // pc
        if col == c_k:
            pcol = loc[ls_blk * nb :, lk * nb : (lk + 1) * nb].contiguous()
        else:
            pcol = a.new_empty((lm_pad - ls_blk * nb, nb))
        mesh.broadcast(pcol, c_k, "cols")

        # 2. the local chain: K1 on the head, K2 on the chunks
        rcur, tg_all[k] = panel_head(pcol, 0, n_head, v_heads, t2_heads, k * c, nb, ib)
        if nch > 0:
            rcur, v_chunks[cb : cb + nch], t2_chunks[cb : cb + nch] = panel_chain(
                pcol[(1 + n_head) * nb :], rcur, 0, nb, 0, nch, c * nb, ib)

        # 3. the TTQRT tree over 'rows', root side only
        t_rot = (r - r_k) % pr
        for li, (down, _, d) in enumerate(_tree_perms(pr, r_k)):
            root, leaf = _roles(t_rot, d, pr)
            if root:
                rnew, tree_v2[k, li], tree_t2[k, li] = ttqrt(rcur, mesh.ppermute_rows(rcur, down))
                rcur = torch.triu(rnew)
            elif leaf:
                mesh.ppermute_rows(rcur, down)

        # 4. the root's R, to every rank
        tile = rcur.contiguous() if (r, col) == (r_k, c_k) else a.new_empty((nb, nb))
        r_diag[k] = mesh.broadcast(tile, (r_k, c_k), "both")

        # 5. the trailing update of the row strip, 6. the strip tree
        cs = (k + 1) // pc + (1 if col < (k + 1) % pc else 0)
        strip = loc[ls_blk * nb : (ls_blk + 1) * nb, cs * nb :]
        bufs = (v_heads, tg_all, t2_heads, v_chunks, t2_chunks, cb)
        _sweep(loc, strip, bufs, k, geo, c, nb, cs, True, precision)
        if pr > 1:
            _strip_tree(mesh, strip, tree_v2[k], tree_t2[k], r_k, True, precision)

    return ShardedFactors(loc, r_diag, v_heads, tg_all, t2_heads, v_chunks, t2_chunks,
                          tree_v2, tree_t2, nb, c, (m, n), (mt, nt, pr, pc), (r, col))


def _unpack(mesh: Mesh, x: torch.Tensor, nb: int) -> torch.Tensor:
    """Block-cyclic local matrices → the global matrix on every rank: all
    gathers over 'cols' then 'rows', then the unpack."""
    return _from_local_layout(mesh.all_gather(mesh.all_gather(x, "cols"), "rows"), nb)


def _check_mesh(f: ShardedFactors, mesh: Mesh) -> None:
    if tuple(f.grid[2:]) != mesh.shape or tuple(f.coords) != (mesh.r, mesh.c):
        raise ValueError(f"factors of rank {f.coords} on a {f.grid[2:]} mesh, given rank "
                         f"({mesh.r}, {mesh.c}) of a {mesh.shape} mesh")


def assemble_r_sharded(f: ShardedFactors, mesh: Mesh) -> torch.Tensor:
    """R (M, N), on every rank."""
    _check_mesh(f, mesh)
    mt, nt, pr, pc = f.grid
    nb = f.nb
    full = _unpack(mesh, f.local[: (mt // pr) * nb, : (nt // pc) * nb], nb)
    r = torch.triu(full)
    for k in range(f.r_diag.shape[0]):
        r[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb] = torch.triu(f.r_diag[k])
    m, n = f.shape
    return r[:m, :n]


def apply_q_sharded(f: ShardedFactors, c_mat: torch.Tensor, mesh: Mesh, trans: bool = True,
                    precision: str = "highest") -> torch.Tensor:
    """C ← Qᵀ·C (trans) or Q·C, on every rank: C (M, P) is the same global
    matrix on every rank; the factor's phases replay on C's block-cyclic
    local matrix, K1/K2 and the R tree excepted."""
    _check_mesh(f, mesh)
    nb, c = f.nb, f.chunk
    mt, nt, pr, pc = f.grid
    k_max, lmt = min(mt, nt), mt // pr
    lmt_pad = _row_pad_tiles(lmt, c)
    mc, p = c_mat.shape
    if mc != f.shape[0]:
        raise ValueError(f"c rows {mc} != M {f.shape[0]}")
    ppad = round_up(max(p, 1), nb * pc)
    cp = torch.nn.functional.pad(c_mat, (0, ppad - p, 0, mt * nb - mc))
    lp = ppad // pc
    cm = c_mat.new_zeros((lmt_pad * nb, lp))
    cm[: lmt * nb] = _local_block(cp, nb, pr, pc, mesh.r, mesh.c)
    del cp
    cbases, _ = _chunk_bases_sh(lmt_pad, pr, c, k_max)
    for i in range(k_max):
        k = i if trans else k_max - 1 - i
        geo = _local_geometry(k, mesh.r, lmt_pad, pr, c)
        strip = cm[geo[0] * nb : (geo[0] + 1) * nb]
        bufs = (f.v_heads, f.tg_all, f.t2_heads, f.v_chunks, f.t2_chunks, cbases[k])
        if trans:
            _sweep(cm, strip, bufs, k, geo, c, nb, 0, True, precision)
        if pr > 1:
            _strip_tree(mesh, strip, f.tree_v2[k], f.tree_t2[k], k % pr, trans, precision)
        if not trans:
            _sweep(cm, strip, bufs, k, geo, c, nb, 0, False, precision)
    return _unpack(mesh, cm[: lmt * nb], nb)[:mc, :p]

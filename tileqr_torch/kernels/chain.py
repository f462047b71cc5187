"""Chunked panel chain K2 and the strip update kernels K3 and K4.

Counterparts of ``tileqr/kernels/chain.py``:

- ``panel_chain`` (K2): TSQRT on ``n_chunks`` couples [R; B], B of
  ``block_rows`` rows, against the carried R, seeded from r_in's upper
  triangle (tileqr's K2 walks a full r_in's strict lower part too; every
  driver passes a triangular one);
- ``couple_strip`` (K3): the SSRFB sweep of the trailing update, with the
  diagonal LARFB fused in at the first couple (forward order) or after the
  last (``reverse``, the Q-apply order);
- ``larfb_strip`` (K4): the diagonal LARFB alone, for a panel with no
  couples;
- ``strip_sweep``: one panel's K3/K4 calls on its row strip, the rule
  every driver's update and Q apply follow.

On a CUDA tensor each wrapper launches its CUDA kernels (``csrc/chain.cu``
for K2, as one thread-block cluster sized by ``geqrt.cluster_plan``;
``csrc/strip.cu`` for K3 and K4); on a CPU tensor it runs the plain version
beside it. K3 and K4 update C and the strip IN PLACE (the JAX kernels alias
C to their output): the strip may be a view of C's row strip, which the
couple rows never touch. K3 and K4 take ``precision``
(``kernels/common.py``): their three products run in the mode's product,
the kernels' instantiation for it on the card; K2 is fp32 in every mode,
as in ``tileqr``.

On the card a K3 call is three launches (one count): every couple's
projection V2ᵀ·C_bot at once, its rows cut into G groups where the strip
is narrow (``strip_plan``); the chain through the strip, which also runs
the fused LARFB, on clusters of 1, 2 or 4 CTAs a 64-column block, each on
a row band of the triangular factors' nonzero part (``chain_bands``);
every couple's C_bot −= V2·W2 at once (the whole-panel apply's phase 2).
K4 is the second launch alone. The plain K3 takes
``groups=G`` (``strip_plan(...).groups`` at the card's SM count) to sum
the projections in the kernel's order; the CPU path runs G = 1, tileqr's
order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import counter_key, dot, dot_t, passes_of, triu
from tileqr_torch.kernels.geqrt import geqrt_in_place
from tileqr_torch.kernels.larfb import larfb_body
from tileqr_torch.kernels.panel import (_cluster_args, _pipelined, _steps, launch_pipelined,
                                        panel_factor)
from tileqr_torch.kernels.panel_apply import sub_plan, tile_count, tiles_for
from tileqr_torch.kernels.ssrfb import ssrfb_body


def _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows):
    m, n = a.shape
    if n_chunks < 1 or block_rows % nb or (k + 1) * nb > n:
        raise ValueError("panel_chain: bad chunk geometry")
    if (base_block + n_chunks) * block_rows > m or (r_in is not None
                                                    and tuple(r_in.shape) != (nb, nb)):
        raise ValueError("panel_chain: chunks run past A or r_in is not (nb, nb)")


def panel_chain_plain(a, r_in, k: int, nb: int, base_block: int, n_chunks: int,
                      block_rows: int, ib: int = 128):
    """Plain torch K2."""
    _build.PLAIN_CALLS["panel_chain"] += 1
    _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows)
    kw = dict(dtype=a.dtype, device=a.device)
    v_chunks = torch.empty((n_chunks, block_rows, nb), **kw)
    t2 = torch.empty((n_chunks, nb, nb), **kw)
    r = triu(r_in)
    for i in range(n_chunks):
        r0 = (base_block + i) * block_rows
        at = torch.empty((nb, nb + block_rows), **kw)
        at[:, :nb] = r.T
        at[:, nb:] = a[r0 : r0 + block_rows, k * nb : (k + 1) * nb].T
        tt = torch.zeros((nb, nb), **kw)
        geqrt_in_place(at, tt, nb, ib)
        r = at[:, :nb].T.contiguous()  # strictly-lower stays exactly 0
        v_chunks[i] = at[:, nb:].T
        t2[i] = tt.T
    return r, v_chunks, t2


def panel_chain(a, r_in, k: int, nb: int, base_block: int, n_chunks: int,
                block_rows: int, ib: int = 128):
    """TSQRT-chain ``n_chunks`` couples of ``block_rows`` rows of panel
    column k against the carried R, seeded from ``r_in``'s upper triangle
    (its strict lower part is not read). On the card two or more couples run
    pipelined by ib block (``panel.pipeline_plan``, the first couple walked
    whole). A is read only.
    Returns (r_out, v_chunks, t2_stack)."""
    if not _build.is_cuda(a, r_in):
        return panel_chain_plain(a, r_in, k, nb, base_block, n_chunks, block_rows, ib)
    _build.require_fp32(a, r_in)
    _build.require_row_major(a=a)
    _build.require_contiguous(r_in=r_in)
    _check_chain(a, r_in, k, nb, base_block, n_chunks, block_rows)
    kw = dict(dtype=a.dtype, device=a.device)
    r_in = triu(r_in)  # the kernels take R upper triangular
    plan = _pipelined(nb, ib, n_chunks, nb + block_rows, full_first=True)
    r = torch.empty((nb, nb), **kw)
    v_chunks = torch.empty((n_chunks, block_rows, nb), **kw)
    t2 = torch.empty((n_chunks, nb, nb), **kw)
    if plan is not None:
        launch_pipelined(plan, a, k, nb, ib, 0, 0, n_chunks, block_rows, base_block * block_rows,
                         r_in, r, (None, None, None), (v_chunks, t2))
    else:
        lib, work, ctas, smem, resident = _cluster_args(nb, nb + block_rows, ib, kw)
        rc = lib.tq_panel_chain(
            a.data_ptr(), a.stride(0), r_in.data_ptr(), k, nb, base_block, n_chunks,
            block_rows, ib, r.data_ptr(), v_chunks.data_ptr(), t2.data_ptr(),
            work.data_ptr(), ctas, smem, resident, _build.stream(),
        )
        _build.check(rc, "panel_chain")
        _build.count_exchange(ctas, n_chunks * nb)
    _build.LAUNCHES["panel_chain"] += 1
    return r, v_chunks, t2


def panel_column(a, k: int, nb: int, ib: int, n_head: int, base_block: int, n_chunks: int,
                 block_rows: int):
    """Panel column k of A whole: K1 (the GEQRT of tile (k, k) and the
    ``n_head`` head couples below it), then K2 (``n_chunks`` couples of
    ``block_rows`` rows from row block ``base_block``) against K1's R. On
    the card, where the chain is pipelined (``panel.pipeline_plan``), ONE
    launch runs all of its couples, the pipeline carried from K1's steps
    into K2's (counted once, as ``panel_factor``); otherwise, and on the
    CPU, ``panel_factor`` then ``panel_chain``. A is read only. Returns
    (r, v_stack, t_geqrt, t2_stack, v_chunks, t2_chunks), K1's and K2's
    outputs; with no chunk, empty chunk stacks."""
    kw = dict(dtype=a.dtype, device=a.device)
    plan = None
    if n_chunks > 0 and _build.is_cuda(a):
        _build.require_fp32(a)
        _build.require_row_major(a=a)
        steps = _steps(a, k, nb, n_head)
        _check_chain(a, None, k, nb, base_block, n_chunks, block_rows)
        plan = _pipelined(nb, ib, steps + n_chunks, nb + block_rows)
    if plan is None:
        r, v_stack, t_geqrt, t2_stack = panel_factor(a, k, nb, ib, n_couples=n_head)
        if n_chunks == 0:
            return (r, v_stack, t_geqrt, t2_stack, a.new_zeros((0, block_rows, nb)),
                    a.new_zeros((0, nb, nb)))
        r, v_chunks, t2_chunks = panel_chain(a, r, k, nb, base_block, n_chunks, block_rows, ib)
        return r, v_stack, t_geqrt, t2_stack, v_chunks, t2_chunks
    r = torch.empty((nb, nb), **kw)
    k1_out = (torch.empty((steps, nb, nb), **kw), torch.empty((nb, nb), **kw),
              torch.empty((steps, nb, nb), **kw))
    k2_out = (torch.empty((n_chunks, block_rows, nb), **kw),
              torch.empty((n_chunks, nb, nb), **kw))
    launch_pipelined(plan, a, k, nb, ib, 1, n_head, n_chunks, block_rows, base_block * block_rows,
                     None, r, k1_out, k2_out)
    _build.LAUNCHES["panel_factor"] += 1
    return (r, *k1_out, *k2_out)


def _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg):
    mc, p = c.shape
    if strip.dim() != 2 or strip.shape[0] != nb or strip.shape[1] != p - col_start * nb:
        raise ValueError(
            f"strip {tuple(strip.shape)} must be (nb, P - col_start·nb) for C {tuple(c.shape)}"
        )
    if v_stack.shape[1:] != (block_rows, nb) or t2_stack.shape[1:] != (nb, nb):
        raise ValueError("couple_strip: v_stack/t2_stack tile shapes")
    if n_chunks and (stack_base + n_chunks > v_stack.shape[0]
                     or (base_block + n_chunks) * block_rows > mc):
        raise ValueError("couple_strip: couples run past the stacks or C")
    if (vkk is None) != (tg is None):
        raise ValueError("couple_strip: pass both vkk and tg, or neither")


# stage 2's strip columns a block (csrc/strip.cu: SC); stage 1's row groups
# are whole stages of GROUP_ALIGN rows and, where G > 1, at least
# GROUP_MIN_ROWS rows each; stage 2's row bands a block, largest first
SLAB_COLS = 64
GROUP_ALIGN = 32
GROUP_MIN_ROWS = 128
CHAIN_BANDS = (4, 2, 1)


class StripPlan(NamedTuple):
    proj_tile: Tuple[int, int]  # stage 1: (P rows, P columns) a block
    groups: int                 # G: row groups of each couple in stage 1
    group_rows: int             # rows of each group (the last may be shorter)
    sub_tile: Tuple[int, int]   # stage 3: (C rows, C columns) a block
    slab_cols: int              # stage 2: strip columns a block
    workspace: int              # floats: partials, W2, the fused LARFB's W and W2
    bands: int = 1              # stage 2: row bands (a cluster's CTAs) a block


def group_rows(rows: int, groups: int) -> int:
    """Rows of each of stage 1's ``groups`` groups of a couple's ``rows``:
    ceil(rows / groups) rounded up to whole 32-row stages."""
    per = -(-rows // groups)
    return -(-per // GROUP_ALIGN) * GROUP_ALIGN


def strip_workspace(nb: int, width: int, couples: int, groups: int, fused: bool) -> int:
    """Floats of K3's workspace: couples·G partials and couples W2 of (nb,
    width), and the fused LARFB's W and W2."""
    return (couples * (groups + 1) + (2 if fused else 0)) * nb * width


def band_rows(nb: int, bands: int) -> int:
    """Rows of each of stage 2's band tiles (csrc/strip.cu): 128 where
    ``bands`` CTAs each get a whole 128-row tile of nb, else 64."""
    return 128 if nb >= 128 * bands else 64


def bands_fit(nb: int, bands: int) -> bool:
    """Whether stage 2 takes ``bands`` row bands at nb: one always; 2 or 4
    on whole 64-row tiles, one tile a CTA at least."""
    return bands == 1 or (bands in CHAIN_BANDS and nb % 64 == 0
                          and nb // band_rows(nb, bands) >= bands)


def chain_bands(nb: int, width: int, sms: int) -> int:
    """Stage 2's row bands a 64-column block: the most of ``CHAIN_BANDS``
    whose CTAs over the strip's blocks fit the card's ``sms`` SMs (and
    ``bands_fit`` nb). Each band multiplies only its rows' nonzero part of
    the triangular factors, so a narrow strip's chain runs on up to 4x the
    SMs with a critical path of a quarter of the products; a wide one keeps
    one CTA a block."""
    blocks = -(-width // SLAB_COLS)
    return next(b for b in CHAIN_BANDS if b == 1 or (blocks * b <= sms and bands_fit(nb, b)))


def strip_plan_at(nb: int, width: int, rows: int, couples: int, proj_tile: Tuple[int, int],
                  groups: int, sub_tile: Tuple[int, int], fused: bool = False,
                  bands: int = 1) -> StripPlan:
    """K3's launches for ``couples`` couples of ``rows`` rows on an (nb,
    width) strip at the given stage-1 tile and G, stage-3 tile and stage-2
    row bands: G cut to the non-empty groups of ``group_rows`` rows (1 with
    no couples, K4). The workspace: couples·G partials and couples W2 of
    (nb, width) floats, and two more for the fused LARFB, whatever the
    bands."""
    if min(nb, width, groups) < 1 or couples < 0 or (couples and rows < 1):
        raise ValueError(f"strip_plan_at: nb={nb}, width={width}, rows={rows}, "
                         f"couples={couples}, groups={groups}")
    if not bands_fit(nb, bands):
        raise ValueError(f"strip_plan_at: bands={bands} at nb={nb}")
    gr = group_rows(rows, groups) if couples else rows
    groups = -(-rows // gr) if couples else 1
    return StripPlan(proj_tile, groups, gr, sub_tile, SLAB_COLS,
                     strip_workspace(nb, width, couples, groups, fused), bands)


def strip_plan(nb: int, width: int, rows: int, couples: int, sms: int,
               precision: str = "highest", fused: bool = False) -> StripPlan:
    """K3's launches on a card of ``sms`` SMs for ``couples`` couples of
    ``rows`` rows on an (nb, width) strip (K4: no couples, ``fused``), from
    the shapes and the SM count only, so that every rank of a world picks
    alike: ``strip_plan_at`` at these tiles and G. Stage 1 takes the mode's
    large tile where its blocks over all couples fill the card, else the
    small one; its G = the SMs those tiles leave (sms // tiles), at most
    rows // GROUP_MIN_ROWS and at least 1 (so G = 1 when the tiles take
    more than half the card). Stage 3 takes ``sub_plan``'s tile for the
    stacked couples; stage 2 ``chain_bands``' row bands."""
    if min(nb, width, sms) < 1 or couples < 0 or (couples and rows < 1):
        raise ValueError(f"strip_plan: nb={nb}, width={width}, rows={rows}, "
                         f"couples={couples}, sms={sms}")
    large, small = tiles_for(precision)
    bands = chain_bands(nb, width, sms)
    if couples == 0:
        return strip_plan_at(nb, width, rows, 0, large, 1, large, fused, bands)
    tile = large if tile_count(nb, width, large, couples) >= sms else small
    groups = max(1, min(rows // GROUP_MIN_ROWS, sms // tile_count(nb, width, tile, couples)))
    return strip_plan_at(nb, width, rows, couples, tile, groups,
                         sub_plan(rows, width, nb, sms, precision, couples).tile, fused, bands)


def _ssrfb_grouped(v2, t2, c_top, c_bot, trans: bool, precision: str, groups: int):
    """``ssrfb_body`` with the projection V2ᵀ·C_bot summed over ``groups``
    groups of ``group_rows`` rows, the partials added in group order and
    then to C_top (stage 1 and 2's order); groups = 1 is ssrfb_body."""
    if groups == 1:
        return ssrfb_body(v2, t2, c_top, c_bot, trans, precision)
    rows = v2.shape[0]
    gr = group_rows(rows, groups)
    proj = None
    for r0 in range(0, rows, gr):
        part = dot_t(v2[r0 : r0 + gr], c_bot[r0 : r0 + gr], precision)
        proj = part if proj is None else proj + part
    w = c_top + proj
    w = dot_t(t2, w, precision) if trans else dot(t2, w, precision)
    return c_top - w, c_bot - dot(v2, w, precision)


def couple_strip_plain(v_stack, t2_stack, c, strip, stack_base: int, base_block: int,
                       n_chunks: int, block_rows: int, nb: int, col_start: int,
                       trans: bool = True, reverse: bool = False, vkk=None, tg=None,
                       precision: str = "highest", counter: str = "couple_strip",
                       groups: int = 1):
    """Plain torch K3 (in place on C and the strip); ``groups``: stage 1's
    row groups of each couple (``strip_plan``; the card's order, to hold
    the kernel to)."""
    _build.PLAIN_CALLS[counter_key(counter, precision)] += 1
    _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg)
    if groups < 1:
        raise ValueError(f"couple_strip_plain: groups={groups}")
    c0 = col_start * nb
    s = strip
    if vkk is not None and not reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    order = range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)
    for ii in order:
        r0 = (base_block + ii) * block_rows
        bot = c[r0 : r0 + block_rows, c0:]
        s, new_bot = _ssrfb_grouped(v_stack[stack_base + ii], t2_stack[stack_base + ii],
                                    s, bot, trans, precision, groups)
        bot.copy_(new_bot)
    if vkk is not None and reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    if s is not strip:
        strip.copy_(s)
    return c, strip


def couple_strip(v_stack, t2_stack, c, strip, stack_base: int, base_block: int,
                 n_chunks: int, block_rows: int, nb: int, col_start: int,
                 trans: bool = True, reverse: bool = False,
                 vkk: Optional[torch.Tensor] = None,
                 tg: Optional[torch.Tensor] = None, precision: str = "highest",
                 counter: str = "couple_strip") -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``n_chunks`` couples to (strip, C), in place.

    v_stack: (B, block_rows, nb) reflector chunks; t2_stack: (B, nb, nb);
    couple ii uses slot stack_base + ii. Its C rows are row block
    base_block + ii (in units of block_rows), columns col_start·nb onward.
    strip: (nb, P − col_start·nb). reverse: couples in descending order.
    vkk/tg: the diagonal-tile LARFB, fused before the first couple (forward)
    or after the last (reverse). precision: the mode of the three products.
    counter: the name the call counts under, keyed by mode. Returns
    (c, strip).
    """
    passes_of(precision)
    if not _build.is_cuda(v_stack, t2_stack, c, strip, vkk, tg):
        return couple_strip_plain(v_stack, t2_stack, c, strip, stack_base, base_block,
                                  n_chunks, block_rows, nb, col_start, trans, reverse,
                                  vkk, tg, precision, counter)
    _build.require_fp32(v_stack, t2_stack, c, strip, vkk, tg)
    _build.require_contiguous(v_stack=v_stack, t2_stack=t2_stack, vkk=vkk, tg=tg)
    _build.require_row_major(c=c, strip=strip)
    _check_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks,
                 block_rows, nb, col_start, vkk, tg)
    width = strip.shape[1]
    if width == 0 or (n_chunks == 0 and vkk is None):
        return c, strip
    plan = strip_plan(nb, width, block_rows, n_chunks, _build.sm_count(c), precision,
                      fused=vkk is not None)
    _launch_strip(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks, block_rows, nb,
                  col_start, trans, reverse, vkk, tg, precision, plan)
    _build.LAUNCHES[counter_key(counter, precision)] += 1
    return c, strip


def _launch_strip(v_stack, t2_stack, c, strip, stack_base: int, base_block: int, n_chunks: int,
                  block_rows: int, nb: int, col_start: int, trans: bool, reverse: bool, vkk, tg,
                  precision: str, plan: StripPlan) -> None:
    """One K3 call on the card at ``plan`` (``strip_plan``'s, or
    ``strip_plan_at``'s at any tiles and G), in place on (c, strip)."""
    work = torch.empty(plan.workspace, dtype=c.dtype, device=c.device)
    rc = _build.lib().tq_couple_strip(
        v_stack.data_ptr(), t2_stack.data_ptr(), c.data_ptr(), c.stride(0),
        strip.data_ptr(), strip.stride(0), strip.shape[1], stack_base, base_block,
        n_chunks, block_rows, nb, col_start, int(trans), int(reverse),
        _build.ptr(vkk), _build.ptr(tg), passes_of(precision), work.data_ptr(), *plan.proj_tile,
        plan.groups, *plan.sub_tile, plan.bands, _build.stream(),
    )
    _build.check(rc, "couple_strip")
    _build.count_strip((plan.proj_tile, plan.groups, plan.sub_tile), n_chunks)
    _build.count_chain(plan.bands, n_chunks)


def larfb_strip_plain(vkk, tg, strip, nb: int, trans: bool = True,
                      precision: str = "highest"):
    """Plain torch K4 (in place on the strip)."""
    _build.PLAIN_CALLS[counter_key("larfb_strip", precision)] += 1
    strip.copy_(larfb_body(vkk, tg, strip, trans, precision))
    return strip


def larfb_strip(vkk, tg, strip, nb: int, trans: bool = True,
                precision: str = "highest") -> torch.Tensor:
    """Apply the diagonal-tile GEQRT reflector block (vkk: packed (nb, nb),
    tg: its T) to the row strip, in place, in the precision mode."""
    if strip.dim() != 2 or strip.shape[0] != nb or tuple(vkk.shape) != (nb, nb):
        raise ValueError("larfb_strip: strip must be (nb, w) and vkk (nb, nb)")
    passes = passes_of(precision)
    if not _build.is_cuda(vkk, tg, strip):
        return larfb_strip_plain(vkk, tg, strip, nb, trans, precision)
    _build.require_fp32(vkk, tg, strip)
    _build.require_contiguous(vkk=vkk, tg=tg)
    _build.require_row_major(strip=strip)
    if strip.shape[1] == 0:
        return strip
    plan = strip_plan(nb, strip.shape[1], 0, 0, _build.sm_count(strip), precision, fused=True)
    work = torch.empty(plan.workspace, dtype=strip.dtype, device=strip.device)
    rc = _build.lib().tq_larfb_strip(
        vkk.data_ptr(), tg.data_ptr(), strip.data_ptr(), strip.stride(0),
        strip.shape[1], nb, int(trans), passes, work.data_ptr(), plan.bands, _build.stream(),
    )
    _build.check(rc, "larfb_strip")
    _build.LAUNCHES[counter_key("larfb_strip", precision)] += 1
    return strip


def strip_sweep(heads: Optional[tuple], chunks: Optional[tuple], vkk: torch.Tensor,
                tg: torch.Tensor, strip: torch.Tensor, nb: int, trans: bool = True,
                precision: str = "highest") -> None:
    """One panel's reflectors on its row strip, in place: the drivers'
    K3/K4 sweep. ``heads`` and ``chunks``: the leading arguments (v_stack
    through col_start) of ``couple_strip`` on the panel's head couples and
    on its chunk couples, None where it has none; vkk/tg: its diagonal
    tile's LARFB. trans (Qᵀ·C, the factor's update): heads with the LARFB
    fused before them, then chunks (fused where there are no heads).
    Otherwise (Q·C) the reverse: chunks, then heads with the LARFB fused
    after them (after the chunks where there are no heads). K4 alone where
    the panel has no couples."""
    calls = [args for args in (heads, chunks) if args is not None]
    if not calls:
        larfb_strip(vkk, tg, strip, nb, trans=trans, precision=precision)
        return
    if not trans:
        calls.reverse()
    fused = 0 if trans else len(calls) - 1
    for i, args in enumerate(calls):
        fuse = dict(vkk=vkk, tg=tg) if i == fused else {}
        couple_strip(*args, trans=trans, reverse=not trans, precision=precision, **fuse)

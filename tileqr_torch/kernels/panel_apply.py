"""The whole-panel block-reflector apply: B6, the hr driver's in-place
trailing update, B7, the value-level apply of the hr ``apply_q`` and
``orgqr``, and B7's two halves, which the sharded hr driver calls with its
sum over the mesh rows between them.

Counterparts of ``tileqr/kernels/panel_apply.py``:

- ``panel_apply_carry`` (B6): carry[s:, s+nb:] ← (I − Y·T·Yᵀ)^{T?} ·
  carry[s:, s+nb:], s = k·nb, everything outside the window untouched;
- ``panel_apply`` (B7): C ← (I − Y·T·Yᵀ)^{T?} · C for an (m, n) C, m and n
  multiples of nb; here C may be any view with unit column stride (a
  window of a larger matrix), updated in place through its leading
  dimension;
- ``panel_project`` (B7a): W = Σᵢ Yᵢᵀ Cᵢ, phase 1 without op(T), over row
  blocks of ``_block(m, nb, 512)`` rows;
- ``panel_sub`` (B7b): C ← C − Y·W in place, phase 2 alone.

Both run two phases, a barrier between them (every row block of Y
contributes to W before any C block is updated):

  phase 1: W = op(T) · Σᵢ Yᵢᵀ Cᵢ over row blocks of ``mr`` rows, in
           order, with Kahan-compensated fp32 accumulation across the
           blocks (``_kahan_add``); mr = ``_block(m, nb, 512)`` for B6 and
           B7a and ``_block(m, nb, 1024)`` for B7, the reference's
           targets (mr sets the order of the sums, so the values);
  phase 2: C ← C − Y · W.

``precision`` (``kernels/common.py``) sets the product of Yᵢᵀ Cᵢ and of
Y·W; the small op(T) product stays the fp32 one in every mode, as the
reference pins it "highest". On a CUDA tensor the wrappers launch
``tq_panel_project`` and ``tq_panel_sub`` (``csrc/panel_apply.cu``), the
instantiation of the mode; on a CPU tensor they run the plain version, the
same blocks in torch.

On the card phase 1 runs the row blocks in G contiguous groups where W's
tiles alone leave the SMs idle (``project_plan``): each group's Kahan pair
is summed on its own, and the pairs are combined in group order
(``_project_plain(..., groups=G)`` is the same order in torch). G = 1, the
reference's single chain, whenever the tiles take more than half the
card, and always on the CPU.

In fp32 a launch of more than one wave whose whole-tile grid would end
on a part-filled wave runs a balanced schedule instead
(``project_ranges``): its units, (W tile, row block), are cut in chain
order (a chain: one tile's row blocks in one group) into contiguous
ranges that differ by at most one unit, one persistent block a range
(``project_walk``). A chain cut between two ranges is summed by both
blocks in turn: the first hands its Kahan pair on, the second folds its
own row blocks into it, so every fold is the plan's and W's bits are
those of the whole-tile grid at the same G.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.common import counter_key, dot, dot_t, passes_of


def _block(extent: int, unit: int, target: int) -> int:
    """Largest multiple of ``unit`` that divides ``extent`` and is ≤
    max(target, unit) (``tileqr/kernels/panel_apply.py:_block``)."""
    g = target // unit
    while g > 1:
        if extent % (g * unit) == 0:
            return g * unit
        g -= 1
    return unit


def _window(y, t, carry, k: int, nb: int):
    """(window view, m, n) of panel k, after checking the shapes."""
    if carry.dim() != 2 or y.dim() != 2 or y.shape[1] != nb or tuple(t.shape) != (nb, nb):
        raise ValueError("panel_apply_carry: y must be (m, nb), t (nb, nb), carry 2-D")
    mp, npad = carry.shape
    s = k * nb
    m = y.shape[0]
    if mp - s != m or m % nb:
        raise ValueError(f"window rows {mp - s} != y rows {m} (or not a multiple of nb)")
    n = npad - s - nb
    if n > 0 and n % nb:
        raise ValueError(f"window columns {n} not a multiple of nb={nb}")
    return carry[s:, s + nb :], m, n


# the widest panel the split instantiations take (``BX_MAX_NB`` in
# csrc/panel_apply.cu, kept from the earlier phase 1, whose W slab and its
# compensation filled shared memory there)
BX_MAX_NB = 768


def kernel_takes(nb: int, precision: str = "highest") -> bool:
    """Whether the mode's CUDA instantiation takes panels nb wide: the fp32
    one nb a multiple of 32 up to 256 (two 128-row W tiles), the split ones
    any nb up to ``BX_MAX_NB`` (and any n)."""
    if passes_of(precision):
        return nb <= BX_MAX_NB
    return nb % 32 == 0 and nb <= 256


def _check_value(y, t, c):
    """(m, n, nb) of a B7 call, after checking the shapes."""
    if c.dim() != 2 or y.dim() != 2 or tuple(t.shape) != (y.shape[1], y.shape[1]):
        raise ValueError("panel_apply: y must be (m, nb), t (nb, nb), c 2-D")
    m, nb = y.shape
    n = c.shape[1]
    if c.shape[0] != m or m % nb or n % nb:
        raise ValueError(f"panel_apply: c {tuple(c.shape)} must have y's {m} rows, and "
                         f"both extents multiples of nb={nb}")
    return m, n, nb


# the W tile a phase-1 block owns (csrc/panel_apply.cu): (W rows, W
# columns) of the fp32 kernel and of the split ones
PROJECT_TILES = {"fp32": (128, 128), "split": (128, 64)}


# one handed chain's Kahan pair in the workspace: (acc, comp) of an fp32 W
# tile (``csrc/panel_apply.cu``: SLOT)
PROJECT_SLOT = 2 * PROJECT_TILES["fp32"][0] * PROJECT_TILES["fp32"][1]


class ProjectPlan(NamedTuple):
    tile: Tuple[int, int]  # (W rows, W columns) a block owns
    groups: int            # G: contiguous groups of the m / mr row blocks
    workspace: int         # floats: the (G, 2, nb, n) Kahan pairs (none where W is written
                           # directly), then ``ranges`` handed pairs and ranges + 1 sync words
    ranges: int = 0        # persistent blocks of the balanced schedule; 0: the whole-tile grid
    handed: int = 0        # chains a block hands on to the next (balanced only)


class Segment(NamedTuple):
    """A part of one chain that one block of the balanced schedule sums."""
    chain: int   # tile chain % tiles (row tile fastest), group chain // tiles
    b0: int      # the launch's row blocks [b0, b1)
    b1: int
    tail: bool   # starts from the pair the previous range's block handed on
    head: bool   # hands its pair on to the next range's block


def _group_size(blocks: int, groups: int) -> int:
    """Row blocks per group: ceil(blocks / groups) (the last group may be
    shorter)."""
    return -(-blocks // groups)


def _groups_at(blocks: int, groups: int) -> int:
    """G cut to the non-empty groups of ceil(blocks / G) row blocks; one
    (empty) group where there are no row blocks."""
    return -(-blocks // _group_size(blocks, groups)) if blocks else 1


def _chain_span(chain: int, tiles: int, rb: int, per: int) -> Tuple[int, int]:
    """[start, end) of a chain among the launch's units, chains in order
    (tile fastest, then group), each as long as its group."""
    z, w = divmod(chain, tiles)
    length = min(per, rb - z * per)
    start = z * tiles * per + w * length
    return start, start + length


def _chain_at(unit: int, tiles: int, rb: int, per: int) -> int:
    """The chain that holds a unit."""
    z = min(unit // (tiles * per), -(-rb // per) - 1)
    return z * tiles + (unit - z * tiles * per) // min(per, rb - z * per)


def _range_span(r: int, units: int, ranges: int) -> Tuple[int, int]:
    """[start, end) of range r: the first units % ranges ranges one unit
    longer."""
    base, extra = divmod(units, ranges)
    start = r * base + min(r, extra)
    return start, start + base + (r < extra)


@functools.lru_cache(maxsize=512)
def project_walk(tiles: int, rb: int, groups: int, ranges: int) -> Tuple[Tuple[Segment, ...], ...]:
    """The balanced schedule of a launch of ``tiles`` W tiles over ``rb``
    row blocks in G = ``groups``: each range's segments in the order its
    block sums them (``csrc/panel_apply.cu:project_f32_kernel``), its last
    chain first and each chain's row blocks ascending, so that a block
    hands its pair on at the start of its run and takes one over at the
    end."""
    per = _group_size(rb, groups)
    units = tiles * rb
    if not 1 <= ranges <= units or groups != _groups_at(rb, groups):
        raise ValueError(f"project_walk: tiles={tiles}, rb={rb}, groups={groups}, "
                         f"ranges={ranges}")
    walk = []
    for r in range(ranges):
        u0, u1 = _range_span(r, units, ranges)
        segs, u = [], u1
        while u > u0:
            chain = _chain_at(u - 1, tiles, rb, per)
            start, end = _chain_span(chain, tiles, rb, per)
            s0 = max(start, u0)
            b = (chain // tiles) * per - start
            segs.append(Segment(chain, b + s0, b + u, start < u0, end > u1))
            u = s0
        walk.append(tuple(segs))
    return tuple(walk)


@functools.lru_cache(maxsize=512)
def project_ranges(tiles: int, rb: int, groups: int, sms: int) -> int:
    """The rule of phase 1's fp32 grid, from the shapes and the SM count:
    the balanced schedule's min(sms, units) blocks where a chain is cut,
    none is cut across more than two ranges (no block both takes a pair
    and hands one on), and the schedule ends sooner than the whole-tile
    grid's waves times its longest chain; else 0, the whole-tile grid. The
    schedule ends with its longest range or its longest cut chain, which
    ends only once its two blocks have summed their parts in turn: so a
    grid of one wave, whose chains are longer than the ranges, gains
    nothing."""
    units = tiles * rb
    if units < 1:
        return 0
    ranges = min(sms, units)
    walk = project_walk(tiles, rb, groups, ranges)
    heads = [segs[0] for segs in walk if segs[0].head]
    if not heads or any(s.head and s.tail for segs in walk for s in segs):
        return 0
    per = _group_size(rb, groups)
    ends = max(-(-units // ranges), *(min(per, rb - s.chain // tiles * per) for s in heads))
    return ranges if ends < -(-tiles * groups // sms) * per else 0


def project_plan_at(m: int, n: int, nb: int, mr: int, groups: int, precision: str = "highest",
                    fold: bool = False, ranges: int = 0) -> ProjectPlan:
    """Phase 1's launch for Y (m, nb), C (m, n) and row blocks of mr rows
    at G = ``groups`` and ``ranges`` blocks of the balanced schedule (0:
    the whole-tile grid; fp32 only): the mode's W tile, G cut to the
    number of non-empty groups of ceil(rb / G) blocks, the workspace of
    the groups' Kahan pairs (none at G = 1 without ``fold``: W written
    directly) and of the schedule's handed pairs, and the chains handed.
    ``fold``: op(T) is folded in (B6, B7), which reads the pairs from the
    workspace at any G. No rows (m = 0) is one empty group: W = 0."""
    if min(n, nb, mr, groups) < 1 or m < 0 or m % mr or ranges < 0:
        raise ValueError(f"project_plan_at: m={m}, n={n}, nb={nb}, mr={mr}, groups={groups}, "
                         f"ranges={ranges}")
    rb = m // mr
    groups = _groups_at(rb, groups)
    work = 0 if groups == 1 and not fold else groups * 2 * nb * n
    tile = PROJECT_TILES["split" if passes_of(precision) else "fp32"]
    handed = 0
    if ranges:
        tiles = -(-nb // tile[0]) * -(-n // tile[1])
        if passes_of(precision) or ranges > tiles * rb:
            raise ValueError(f"project_plan_at: {ranges} ranges of {tiles * rb} units in "
                             f"{precision!r} (fp32 only)")
        handed = sum(s.head for r in project_walk(tiles, rb, groups, ranges) for s in r)
        work += ranges * PROJECT_SLOT + ranges + 1
    return ProjectPlan(tile, groups, work, ranges, handed)


def project_plan(m: int, n: int, nb: int, mr: int, sms: int, precision: str = "highest",
                 fold: bool = False) -> ProjectPlan:
    """Phase 1's launch on a card of ``sms`` SMs for Y (m, nb), C (m, n)
    and row blocks of mr rows: ``project_plan_at`` at G = the SMs the
    mode's W tiles leave, sms // tiles, at most one group per row block and
    at least 1 (so G = 1 when the tiles take more than half the card), and
    in fp32 at ``project_ranges``' blocks."""
    if min(n, nb, mr, sms) < 1 or m < 0 or m % mr:
        raise ValueError(f"project_plan: m={m}, n={n}, nb={nb}, mr={mr}, sms={sms}")
    tile = PROJECT_TILES["split" if passes_of(precision) else "fp32"]
    tiles = -(-nb // tile[0]) * -(-n // tile[1])
    rb = m // mr
    groups = _groups_at(rb, max(1, min(rb, sms // tiles)))
    ranges = 0 if passes_of(precision) else project_ranges(tiles, rb, groups, sms)
    return project_plan_at(m, n, nb, mr, groups, precision, fold, ranges)


# phase 2's C tiles (csrc/panel_apply.cu, tile_gemm.cuh): the large and the
# small tile of the fp32 route and of the split ones; K3's stages take the
# same tiles (kernels/chain.py:strip_plan)
SUB_TILES = {"fp32": ((128, 128), (64, 64)), "split": ((128, 64), (64, 64))}


class SubPlan(NamedTuple):
    tile: Tuple[int, int]  # (C rows, C columns) a block owns


def tiles_for(precision: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(large, small) tile of the mode's route."""
    return SUB_TILES["split" if passes_of(precision) else "fp32"]


def tile_count(m: int, n: int, tile: Tuple[int, int], batch: int = 1) -> int:
    """Blocks of a (m, n) output (``batch`` of them) cut into ``tile``s."""
    return batch * -(-m // tile[0]) * -(-n // tile[1])


def sub_plan(m: int, n: int, nb: int, sms: int, precision: str = "highest",
             batch: int = 1) -> SubPlan:
    """Phase 2's launch on a card of ``sms`` SMs for C (m, n) −= Y (m, nb)
    W (nb, n) (``batch`` such products in one launch, K3's stage 3): the
    mode's large C tile wherever its blocks fill the card at least once,
    else the small one (late hr panels, narrow late strips), from the
    shapes and the SM count only, so that every rank of a world picks
    alike. The tile does not change a C entry's sum."""
    if min(m, n, nb, sms, batch) < 1:
        raise ValueError(f"sub_plan: m={m}, n={n}, nb={nb}, sms={sms}, batch={batch}")
    large, small = tiles_for(precision)
    return SubPlan(large if tile_count(m, n, large, batch) >= sms else small)


def card_project_plan(y: torch.Tensor, c: torch.Tensor, mr: int, precision: str,
                      fold: bool) -> ProjectPlan:
    """The plan phase 1 takes on the card for Y, C (``project_plan`` at the
    card's SM count); the plain versions take its G as ``groups`` to sum in
    the kernel's order."""
    m, nb = y.shape
    return project_plan(m, c.shape[1], nb, mr, _build.sm_count(c), precision, fold)


def _project_plain(y, c, mr: int, precision: str, groups: int = 1) -> torch.Tensor:
    """Phase 1 without op(T) in torch: Σᵢ Yᵢᵀ Cᵢ, Kahan-summed in order
    over the row blocks of each of ``groups`` contiguous groups (ceil(rb /
    groups) blocks each), then the groups' pairs combined in group order:
    each later group's acc − comp Kahan-added to the running pair. groups
    = 1 is the reference's single chain."""
    rb = y.shape[0] // mr
    per = max(1, _group_size(rb, groups))
    acc = c.new_zeros((y.shape[1], c.shape[1]))
    comp = c.new_zeros(acc.shape)
    for b0 in range(0, rb, per):
        a_g = c.new_zeros(acc.shape)
        c_g = c.new_zeros(acc.shape)
        for r0 in range(b0 * mr, min(rb, b0 + per) * mr, mr):
            val = dot_t(y[r0 : r0 + mr], c[r0 : r0 + mr], precision)
            yk = val - c_g
            tk = a_g + yk
            c_g = (tk - a_g) - yk
            a_g = tk
        if b0 == 0:
            acc, comp = a_g, c_g
        else:
            yk = (a_g - c_g) - comp
            tk = acc + yk
            comp = (tk - acc) - yk
            acc = tk
    return acc


def _apply_plain(y, t, c, mr: int, trans: bool, precision: str, groups: int = 1) -> None:
    """The two phases in torch, in place on the (m, n) view c."""
    tm = t.T if trans else t
    c -= dot(y, tm @ _project_plain(y, c, mr, precision, groups), precision)


def _require_kernel(y, c, nb: int, precision: str) -> None:
    """The checks of every launch: fp32, Y contiguous, C row-major, an nb
    the mode's instantiation takes."""
    _build.require_fp32(y, c)
    _build.require_contiguous(y=y)
    _build.require_row_major(c=c)
    if not kernel_takes(nb, precision):
        raise ValueError(
            f"the panel apply kernels take nb a multiple of 32, <= 256 in 'highest' and nb "
            f"<= {BX_MAX_NB} in the split modes; got nb={nb} in {precision!r}")


def _launch_project(y, tm: Optional[torch.Tensor], c, mr: int, precision: str,
                    plan: ProjectPlan) -> torch.Tensor:
    """Phase 1 on the card at ``plan`` (``project_plan``'s, or
    ``project_plan_at``'s at any G and schedule): W (nb, n) = tm·Σᵢ Yᵢᵀ Cᵢ, or the bare
    sum when tm is None."""
    m, nb = y.shape
    n = c.shape[1]
    w = torch.empty((nb, n), dtype=c.dtype, device=c.device)
    work = torch.empty(plan.workspace, dtype=c.dtype, device=c.device) if plan.workspace else None
    passes = passes_of(precision)
    rc = _build.lib().tq_panel_project(y.data_ptr(), _build.ptr(tm), c.data_ptr(), c.stride(0),
                                       m, n, nb, mr, w.data_ptr(), _build.ptr(work), plan.groups,
                                       plan.ranges, passes, _build.stream())
    _build.check(rc, "panel_project")
    if not passes:
        _build.count_project(plan.ranges, plan.handed)
    return w


def _launch_sub(y, w, c, precision: str, plan: SubPlan) -> None:
    """Phase 2 on the card: C −= Y·W in place, on ``plan``'s tile
    (``sub_plan``'s, or any tile of the mode's route)."""
    m, nb = y.shape
    rc = _build.lib().tq_panel_sub(y.data_ptr(), w.data_ptr(), c.data_ptr(), c.stride(0), m,
                                   c.shape[1], nb, *plan.tile, passes_of(precision),
                                   _build.stream())
    _build.check(rc, "panel_sub")


def _sub_on_card(y, w, c, precision: str) -> None:
    """Phase 2 at ``sub_plan``'s tile for the card; nothing on an empty C."""
    m, nb = y.shape
    if m and c.shape[1]:
        _launch_sub(y, w, c, precision, sub_plan(m, c.shape[1], nb, _build.sm_count(c), precision))


def _apply_kernel(y, t, c, mr: int, trans: bool, precision: str) -> None:
    """Launch both phases on the (m, n) view c, in place."""
    _require_kernel(y, c, y.shape[1], precision)
    _build.require_fp32(t)
    tm = (t.T if trans else t).contiguous()
    w = _launch_project(y, tm, c, mr, precision, card_project_plan(y, c, mr, precision, True))
    _sub_on_card(y, w, c, precision)


def panel_apply_carry_plain(y, t, carry, k: int, nb: int, trans: bool = True,
                            precision: str = "highest", groups: int = 1):
    """Plain torch B6 (in place on carry); ``groups``: phase 1's row-block
    groups (``project_plan``; the card's order, to hold the kernel to)."""
    _build.PLAIN_CALLS[counter_key("panel_apply_carry", precision)] += 1
    c, m, n = _window(y, t, carry, k, nb)
    if n > 0:
        _apply_plain(y, t, c, _block(m, nb, 512), trans, precision, groups)
    return carry


def panel_apply_carry(y: torch.Tensor, t: torch.Tensor, carry: torch.Tensor, k: int,
                      nb: int, trans: bool = True, precision: str = "highest") -> torch.Tensor:
    """Apply panel k's block reflector (Y (m, nb), T (nb, nb)) to the
    window carry[k·nb:, (k+1)·nb:] in place, in the precision mode;
    returns carry."""
    passes_of(precision)
    if not _build.is_cuda(y, t, carry):
        return panel_apply_carry_plain(y, t, carry, k, nb, trans, precision)
    _build.require_row_major(carry=carry)
    c, m, n = _window(y, t, carry, k, nb)
    if n <= 0:
        return carry
    _apply_kernel(y, t, c, _block(m, nb, 512), trans, precision)
    _build.LAUNCHES[counter_key("panel_apply_carry", precision)] += 1
    return carry


def panel_apply_plain(y, t, c, trans: bool = True, precision: str = "b3", groups: int = 1):
    """Plain torch B7 (in place on c); ``groups`` as for B6."""
    _build.PLAIN_CALLS[counter_key("panel_apply", precision)] += 1
    m, n, nb = _check_value(y, t, c)
    if n > 0:
        _apply_plain(y, t, c, _block(m, nb, 1024), trans, precision, groups)
    return c


def panel_apply(y: torch.Tensor, t: torch.Tensor, c: torch.Tensor, trans: bool = True,
                precision: str = "b3") -> torch.Tensor:
    """C ← (I − Y·T·Yᵀ)ᵀ C (trans) or (I − Y·T·Yᵀ) C, in place on the
    (m, n) view c (unit column stride), in the precision mode; returns c.
    y: (m, nb) whole-panel reflectors, t: (nb, nb); m and n multiples of
    nb."""
    passes_of(precision)
    if not _build.is_cuda(y, t, c):
        return panel_apply_plain(y, t, c, trans, precision)
    m, n, nb = _check_value(y, t, c)
    if n == 0:
        return c
    _apply_kernel(y, t, c, _block(m, nb, 1024), trans, precision)
    _build.LAUNCHES[counter_key("panel_apply", precision)] += 1
    return c


def _check_half(y, c, what: str):
    """(m, n, nb) of a B7a/B7b call: c rows must be y's (the reference's
    ValueError), both extents multiples of nb."""
    if y.dim() != 2 or c.dim() != 2:
        raise ValueError(f"{what}: y must be (m, nb) and c 2-D")
    m, nb = y.shape
    mc, n = c.shape
    if mc != m:
        raise ValueError(f"c rows {mc} != y rows {m}")
    if m % nb or n % nb:
        raise ValueError(f"{what}: c {tuple(c.shape)} extents must be multiples of nb={nb}")
    return m, n, nb


def panel_project_plain(y, c, precision: str = "b3", groups: int = 1) -> torch.Tensor:
    """Plain torch B7a; ``groups`` as for B6."""
    _build.PLAIN_CALLS[counter_key("panel_project", precision)] += 1
    m, _, nb = _check_half(y, c, "panel_project")
    return _project_plain(y, c, _block(m, nb, 512), precision, groups)


def panel_project(y: torch.Tensor, c: torch.Tensor, precision: str = "b3") -> torch.Tensor:
    """W (nb, n) = Yᵀ·C, Kahan-summed over row blocks of
    ``_block(m, nb, 512)`` rows, in the precision mode: the projection half
    of the whole-panel apply, so that a sum over the mesh rows can sit
    between it and ``panel_sub`` (the sharded hr driver's update).
    y: (m, nb) contiguous; c: (m, n) with unit column stride."""
    passes_of(precision)
    if not _build.is_cuda(y, c):
        return panel_project_plain(y, c, precision)
    m, n, nb = _check_half(y, c, "panel_project")
    _require_kernel(y, c, nb, precision)
    mr = _block(m, nb, 512)
    w = _launch_project(y, None, c, mr, precision, card_project_plan(y, c, mr, precision, False))
    _build.LAUNCHES[counter_key("panel_project", precision)] += 1
    return w


def panel_sub_plain(y, w, c, precision: str = "b3"):
    """Plain torch B7b (in place on c)."""
    _build.PLAIN_CALLS[counter_key("panel_sub", precision)] += 1
    _check_half(y, c, "panel_sub")
    c -= dot(y, w, precision)
    return c


def panel_sub(y: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
              precision: str = "b3") -> torch.Tensor:
    """C ← C − Y·W in place on the (m, n) view c (the reference aliases C
    to the output), in the precision mode; returns c. w: (nb, n)."""
    passes_of(precision)
    if not _build.is_cuda(y, w, c):
        return panel_sub_plain(y, w, c, precision)
    m, n, nb = _check_half(y, c, "panel_sub")
    if tuple(w.shape) != (nb, n):
        raise ValueError(f"panel_sub: w {tuple(w.shape)} must be ({nb}, {n})")
    _require_kernel(y, c, nb, precision)
    _build.require_fp32(w)
    _build.require_contiguous(w=w)
    _sub_on_card(y, w, c, precision)
    _build.LAUNCHES[counter_key("panel_sub", precision)] += 1
    return c

"""Phase 1 of the whole-panel apply (B6, B7, B7a) on the card runs its row
blocks in G contiguous groups where W's tiles alone leave SMs idle
(``tileqr_torch/kernels/panel_apply.py:project_plan``); the plain version
takes the same G (``_project_plain(..., groups=G)``). On the CPU:

- the plan at the main paths' shapes: the tile, G and the workspace (B7a
  at the sharded hr path's 4096×256·4096×8192 slice, B6 on the hr path's
  16384² panels, B7 in the tsqr cholqr2 factor at nb = 512), G = 1
  wherever the tiles take more than half the card, never more groups than
  row blocks and no group empty, and its raises;
- ``_project_plain(groups=G)`` against tileqr's ``panel_project`` (B7a)
  and ``panel_apply_carry`` (B6), Pallas in interpret mode, on the same
  numpy inputs: float32 "highest" relative Frobenius ≤ 1e-6, b3/b4 ≤ 1e-5
  (the groups end their sums in another order than the reference's single
  chain, each compensated, so the two differ at the fp32 sums' rounding;
  b3/b4 as ``test_torch_sharded_hr_kernels.py`` holds B7a), B6 max abs ≤
  3e-6·max|C| as ``test_torch_hr_kernels.py`` holds it; float64 ≤ 1e-12
  against numpy's product (every mode is exact in float64; tileqr's
  kernels hold their sums in float32 scratch, so they are no float64
  reference);
- ``groups=1`` is bitwise the single Kahan chain of the plain version
  before groups existed (``_single_chain`` below), so the CPU path, which
  always takes it, is unchanged;
- the fp32 launches' balanced schedule (``project_walk``,
  ``project_ranges``): every (chain, row block) in exactly one range,
  ranges within one unit of each other, no chain across more than two
  ranges where the plan takes it, the whole-tile grid exactly where the
  rule says (against a count of the units by brute force), no rank read;
  and a torch emulation of the schedule, the head's pair handed on and
  the tail's partials folded into it, bitwise ``_project_plain(...,
  groups=G)`` in float32 and float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.kernels import panel_apply as jpa
from tileqr_torch.kernels import _build, panel_apply
from tileqr_torch.kernels.common import dot_t

H100_SMS = 132


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def t(x):
    return torch.tensor(np.asarray(x))


def _single_chain(y, c, mr, precision):
    """The plain phase 1 as it was before groups: one Kahan chain over the
    row blocks in order."""
    acc = c.new_zeros((y.shape[1], c.shape[1]))
    comp = c.new_zeros(acc.shape)
    for r0 in range(0, y.shape[0], mr):
        val = dot_t(y[r0 : r0 + mr], c[r0 : r0 + mr], precision)
        yk = val - comp
        tk = acc + yk
        comp = (tk - acc) - yk
        acc = tk
    return acc


# ---- the plan ----

# the balanced schedule's workspace beyond the groups' pairs: a handed pair
# a block, the ticket and a flag a block
HAND = 132 * 2 * 128 * 128 + 133

# (m, n, nb, mr, precision, fold) → (tile, G, workspace floats, balanced
# blocks, chains handed)
PLAN_CASES = {
    # B7a, rank (0, 0)'s segment-0 slice of the 16384² sharded hr path: 128
    # tiles of 8 row blocks fill one wave, so the whole-tile grid
    "b7a-fp32": ((4096, 8192, 256, 512, "highest", False), ((128, 128), 1, 0, 0, 0)),
    "b7a-b3": ((4096, 8192, 256, 512, "b3", False), ((128, 64), 1, 0, 0, 0)),
    "b7a-default": ((4096, 8192, 256, 512, "default", False), ((128, 64), 1, 0, 0, 0)),
    # B6, panel 0 of the 16384² hr path: 252 tiles, one group; the fold
    # reads W's pair from the workspace; 8064 units on 132 blocks of 61 or
    # 62 against two waves of 32, 128 chains handed
    "b6-panel0": ((16384, 16128, 256, 512, "highest", True),
                  ((128, 128), 1, 2 * 256 * 16128 + HAND, 132, 128)),
    # B6, panel 29: 136 tiles of 35 row blocks (mr = 256), which the
    # whole-tile grid runs in two waves of 35 against ranges of 36 or 37
    "b6-panel29": ((8960, 8704, 256, 256, "highest", True),
                   ((128, 128), 1, 2 * 256 * 8704 + HAND, 132, 128)),
    # B6, panel 48: 60 tiles leave 72 SMs, two groups of the 8 row blocks;
    # ranges of 3 or 4 blocks save nothing on chains of 4
    "b6-panel48": ((4096, 3840, 256, 512, "highest", True),
                   ((128, 128), 2, 2 * 2 * 256 * 3840, 0, 0)),
    # B6, panel 62: one row block, so one group however idle the card
    "b6-panel62": ((512, 256, 256, 512, "highest", True), ((128, 128), 1, 2 * 256 * 256, 0, 0)),
    # B7 in b3 of the tsqr cholqr2 factor (1048576 × 512, nb = 512, mr =
    # 1024): 32 tiles, four groups of 256 row blocks
    "tsqr-factor-b3": ((1048576, 512, 512, 1024, "b3", True),
                       ((128, 64), 4, 4 * 2 * 512 * 512, 0, 0)),
    # a narrow bare sum: 4 tiles, 32 row blocks, every block its own group
    "narrow": ((16384, 256, 256, 512, "highest", False),
               ((128, 128), 32, 32 * 2 * 256 * 256, 0, 0)),
    # 32 tiles leave room for 4 groups of 5 row blocks: ceil(5 / 4) = 2 blocks
    # a group, so 3 groups
    "uneven": ((2560, 1024, 256, 512, "b4", False), ((128, 64), 3, 3 * 2 * 256 * 1024, 0, 0)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=str)
def test_project_plan_at_the_main_paths_shapes(case):
    (m, n, nb, mr, prec, fold), want = PLAN_CASES[case]
    plan = panel_apply.project_plan(m, n, nb, mr, H100_SMS, prec, fold=fold)
    assert plan == want


def test_project_plan_high_takes_the_split_tile():
    assert panel_apply.project_plan(4096, 8192, 256, 512, H100_SMS, "high").tile == (128, 64)


def _hr_panels(n, nb):
    """(m, n, mr) of B6 on each panel of the n² hr path."""
    out = []
    for k in range(n // nb - 1):
        m = n - k * nb
        out.append((m, n - (k + 1) * nb, panel_apply._block(m, nb, 512)))
    return out


@pytest.mark.parametrize("prec", ["highest", "b3"])
@pytest.mark.parametrize("n", [4096, 16384])
def test_project_plan_invariants_on_the_hr_panels(prec, n):
    """Every B6 launch of the n² hr path: G = 1 where the tiles take more
    than half the card, else the tiles times G at most the card; no more
    groups than row blocks, none empty."""
    nb = 256
    for m, w, mr in _hr_panels(n, nb):
        plan = panel_apply.project_plan(m, w, nb, mr, H100_SMS, prec, fold=True)
        tr, tc = plan.tile
        tiles = -(-nb // tr) * -(-w // tc)
        rb = m // mr
        per = -(-rb // plan.groups)
        assert 1 <= plan.groups <= rb and per * (plan.groups - 1) < rb
        if 2 * tiles > H100_SMS:
            assert plan.groups == 1
        else:
            assert tiles * plan.groups <= H100_SMS
        hand = plan.ranges * panel_apply.PROJECT_SLOT + plan.ranges + 1 if plan.ranges else 0
        assert plan.workspace == plan.groups * 2 * nb * w + hand
        assert plan.ranges == 0 or (prec == "highest" and plan.ranges == min(H100_SMS, tiles * rb))


def test_project_plan_keeps_one_group_on_the_wide_hr_panels():
    """The 16384² hr path's panels 0-46 (fp32 tiles of 128 columns: more
    than 66 of them) keep tileqr's single chain, so their bits are the
    earlier kernel's; the narrower ones after take groups."""
    groups = [panel_apply.project_plan(m, w, 256, mr, H100_SMS, fold=True).groups
              for m, w, mr in _hr_panels(16384, 256)]
    assert groups[:47] == [1] * 47 and min(groups[47:-1]) > 1


@pytest.mark.parametrize("args", [(4096, 8192, 256, 500, 132), (-8, 8, 8, 8, 132),
                                  (64, 0, 8, 8, 132), (64, 8, 8, 8, 0)],
                         ids=["ragged-mr", "negative-rows", "no-columns", "no-sms"])
def test_project_plan_raises(args):
    with pytest.raises(ValueError, match="project_plan"):
        panel_apply.project_plan(*args)


@pytest.mark.parametrize("fold", [False, True])
def test_no_rows_is_one_empty_group(fold):
    """A rank's slice with no rows (m = 0 passes the halves' checks): one
    group, and the sum is W = 0, as the single chain gives."""
    plan = panel_apply.project_plan(0, 128, 64, 512, H100_SMS, "b3", fold=fold)
    assert plan.groups == 1 and plan.workspace == (2 * 64 * 128 if fold else 0)
    y, c = torch.zeros((0, 64)), torch.zeros((0, 128))
    assert torch.equal(panel_apply.panel_project(y, c, "b3"), torch.zeros((64, 128)))
    assert torch.equal(panel_apply._project_plain(y, c, 512, "b3", groups=1),
                       _single_chain(y, c, 512, "b3"))


# ---- the grouped plain version against the reference ----

TOL = {"b3": 1e-5, "b4": 1e-5, "highest": 1e-6}
# (m, nb, n): 3 row blocks of 512 at nb = 64, 4 of 320 at nb = 32
SHAPES = [(1536, 64, 192), (1280, 32, 96)]


def inputs(m, nb, n, dt, seed=0):
    g = np.random.default_rng(seed)
    return g.standard_normal((m, nb)).astype(dt), g.standard_normal((m, n)).astype(dt)


@pytest.mark.parametrize("mode", ["highest", "b3", "b4"])
@pytest.mark.parametrize("m,nb,n", SHAPES, ids=["3blocks", "4blocks"])
def test_grouped_projection_matches_tileqr_panel_project(m, nb, n, mode):
    y, c = inputs(m, nb, n, np.float32)
    want = jpa.panel_project(jnp.asarray(y), jnp.asarray(c), mode, interpret=True)
    mr = panel_apply._block(m, nb, 512)
    rb = m // mr
    for groups in range(1, rb + 1):
        got = panel_apply._project_plain(t(y), t(c), mr, mode, groups=groups)
        assert got.shape == (nb, n) and rel(got, want) <= TOL[mode], groups


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_grouped_b6_matches_tileqr_panel_apply_carry(groups, trans):
    """B6's two phases with phase 1 in groups: C − Y·(op(T)·W) against
    tileqr's panel_apply_carry on window 0 of a (1536, 1600) carry, nb = 64
    (3 row blocks of 512)."""
    m, nb = 1536, 64
    g = np.random.default_rng(5)
    carry = g.standard_normal((m, m + nb)).astype(np.float32)
    y = (g.standard_normal((m, nb)) / np.sqrt(m)).astype(np.float32)
    tt = np.triu(g.standard_normal((nb, nb)) / nb).astype(np.float32)
    want = np.asarray(jpa.panel_apply_carry(
        jnp.asarray(y), jnp.asarray(tt), jnp.asarray(carry), k=0, nb=nb, trans=trans,
        precision="highest", interpret=True))
    win = t(carry)[:, nb:]
    tm = t(tt).T if trans else t(tt)
    w = tm @ panel_apply._project_plain(t(y), win, panel_apply._block(m, nb, 512), "highest",
                                         groups=groups)
    got = win - t(y) @ w
    assert np.abs(got.numpy() - want[:, nb:]).max() <= 3e-6 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["highest", "b3", "b4", "default"])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_grouped_projection_is_exact_in_float64(groups, mode):
    y, c = inputs(1536, 64, 192, np.float64, seed=2)
    got = panel_apply._project_plain(t(y), t(c), 512, mode, groups=groups)
    assert rel(got, y.T @ c) <= 1e-12


@pytest.mark.parametrize("mode", ["highest", "b3", "b4", "default"])
@pytest.mark.parametrize("m,nb,n", SHAPES, ids=["3blocks", "4blocks"])
def test_one_group_is_the_single_chain_bitwise(m, nb, n, mode):
    y, c = (t(x) for x in inputs(m, nb, n, np.float32, seed=3))
    mr = panel_apply._block(m, nb, 512)
    assert torch.equal(panel_apply._project_plain(y, c, mr, mode),
                       _single_chain(y, c, mr, mode))
    assert torch.equal(panel_apply._project_plain(y, c, mr, mode, groups=1),
                       _single_chain(y, c, mr, mode))


def test_groups_combine_in_group_order():
    """G groups of one row block each: group 0's pair, then each later
    group's acc − comp Kahan-added in order (comp is 0 for one block), so
    the result is the Kahan chain of the block partials: a 1.0 and fifteen
    partials of 2⁻²⁵, each below half an ulp of the running sum, which a
    plain fp32 sum of the groups would drop."""
    nb, blocks = 8, 16
    y = torch.eye(nb).repeat(blocks, 1)
    vals = torch.full((blocks,), 2.0 ** -25)
    vals[0] = 1.0
    c = vals.repeat_interleave(nb)[:, None] * torch.ones((1, 8))
    got = panel_apply._project_plain(y, c, nb, "highest", groups=blocks)
    assert torch.equal(got, _single_chain(y, c, nb, "highest"))
    assert (got > 1.0 + 2.0 ** -24).all()
    assert (got - (1.0 + 15 * 2.0 ** -25)).abs().max() <= 2.0 ** -23


def test_the_cpu_path_takes_one_group():
    """panel_project on CPU tensors is the plain version at groups = 1,
    whatever the card's plan would be for the shape."""
    y, c = (t(x) for x in inputs(16384, 64, 64, np.float32, seed=4))
    assert panel_apply.project_plan(16384, 64, 64, 512, H100_SMS, "b3").groups > 1
    assert torch.equal(panel_apply.panel_project(y, c, "b3"), _single_chain(y, c, 512, "b3"))


# ---- the balanced schedule of the fp32 launches ----


def _hr_launches(n, nb=256):
    """(m, n, mr) of every fp32 phase-1 launch of one n² hr ``qr``: B6 on
    each panel with columns right of it, then B7 on Q's windows wider than
    1024 columns (``square_hr._apply_route``)."""
    b6 = _hr_panels(n, nb)
    b7 = [(n - k * nb, n - k * nb, panel_apply._block(n - k * nb, nb, 1024))
          for k in range(n // nb) if n - k * nb > 1024]
    return b6 + b7


def _units_of(plan, m, n, nb, mr):
    tiles = -(-nb // plan.tile[0]) * -(-n // plan.tile[1])
    return tiles, m // mr


# (tiles, row blocks, G, ranges): one group with chains cut, groups of 3 and
# a shorter last one, one unit a range, a range inside one chain (a block
# that both takes and hands on a pair, which the rule never picks), B6 at
# panels 0 and 29 of 16384² and B7 at window 0
WALKS = [(3, 6, 1, 4), (3, 8, 3, 7), (2, 2, 1, 4), (2, 9, 1, 5), (252, 32, 1, 132),
         (136, 35, 1, 132), (256, 16, 1, 132), (5, 7, 2, 9)]


@pytest.mark.parametrize("tiles,rb,groups,ranges", WALKS, ids=str)
def test_every_unit_lies_in_exactly_one_range(tiles, rb, groups, ranges):
    """Each (chain, row block) of the launch in one segment of one range,
    the ranges' unit counts within one of each other, each range's chains
    walked last first with its row blocks ascending, a head only at a
    range's first segment and a tail only at its last, and each head
    taken over by the next range's tail of the same chain."""
    walk = panel_apply.project_walk(tiles, rb, groups, ranges)
    per = -(-rb // groups)
    want = {(z * tiles + w, b) for z in range(groups) for w in range(tiles)
            for b in range(z * per, min(rb, (z + 1) * per))}
    got = [(s.chain, b) for segs in walk for s in segs for b in range(s.b0, s.b1)]
    assert len(got) == len(set(got)) and set(got) == want
    sizes = [sum(s.b1 - s.b0 for s in segs) for segs in walk]
    assert len(walk) == ranges and max(sizes) - min(sizes) <= 1
    for r, segs in enumerate(walk):
        assert [s.chain for s in segs] == sorted((s.chain for s in segs), reverse=True)
        assert all(not s.head for s in segs[1:]) and all(not s.tail for s in segs[:-1])
        if segs[0].head:
            nxt = walk[r + 1][-1]
            assert nxt.tail and nxt.chain == segs[0].chain and nxt.b0 == segs[0].b1


def _crossings(walk):
    """Ranges each chain falls in."""
    out = {}
    for segs in walk:
        for s in segs:
            out[s.chain] = out.get(s.chain, 0) + 1
    return out


@pytest.mark.parametrize("n", [4096, 16384])
def test_no_balanced_launch_cuts_a_chain_across_more_than_two_ranges(n):
    for m, w, mr in _hr_launches(n):
        plan = panel_apply.project_plan(m, w, 256, mr, H100_SMS, fold=True)
        if plan.ranges:
            tiles, rb = _units_of(plan, m, w, 256, mr)
            walk = panel_apply.project_walk(tiles, rb, plan.groups, plan.ranges)
            cuts = _crossings(walk)
            assert max(cuts.values()) <= 2
            assert plan.handed == sum(v == 2 for v in cuts.values()) > 0


def _rule_by_units(tiles, rb, groups, sms):
    """The rule counted unit by unit, apart from ``project_walk``: each
    unit's chain and range listed, chains spanning more than two ranges or
    none spanning two refused, then the longest range and the longest cut
    chain (summed by its two blocks in turn) against the whole-tile grid's
    waves times its longest chain."""
    per = -(-rb // groups)
    chains = [z * tiles + w for z in range(groups) for w in range(tiles)
              for _ in range(z * per, min(rb, (z + 1) * per))]
    units = len(chains)
    if not units:
        return 0
    ranges = min(sms, units)
    base, extra = divmod(units, ranges)
    owner = [r for r in range(ranges) for _ in range(base + (r < extra))]
    spans = {}
    for ch, r in zip(chains, owner):
        spans.setdefault(ch, set()).add(r)
    widest = max(len(v) for v in spans.values())
    if widest > 2 or widest < 2:
        return 0
    cut = max(chains.count(ch) for ch, v in spans.items() if len(v) == 2)
    ends = max(base + (extra > 0), cut)
    return ranges if ends < -(-tiles * groups // sms) * per else 0


SMALL = [(t, rb, g, sms) for t in (1, 3, 8, 20) for rb in (1, 2, 5, 9) for g in (1, 2, 3)
         for sms in (4, 7, 16) if g <= rb and panel_apply._groups_at(rb, g) == g]


@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_the_whole_tile_grid_is_chosen_exactly_where_the_rule_says(sms):
    """``project_ranges`` against the rule counted unit by unit, on every
    fp32 launch of the 4096² and 16384² hr ``qr`` and on small launches of
    1-20 tiles, 1-9 row blocks and 1-3 groups."""
    cases = set()
    for n in (4096, 16384):
        for m, w, mr in _hr_launches(n):
            plan = panel_apply.project_plan(m, w, 256, mr, sms, fold=True)
            cases.add((*_units_of(plan, m, w, 256, mr), plan.groups, sms))
    cases |= {c for c in SMALL if c[3] == sms or sms == H100_SMS}
    for tiles, rb, groups, s in sorted(cases):
        assert panel_apply.project_ranges(tiles, rb, groups, s) == _rule_by_units(
            tiles, rb, groups, s), (tiles, rb, groups, s)


def test_the_16384_hr_launches_by_schedule():
    """The 123 fp32 launches of one 16384² hr ``qr`` on 132 SMs: 60
    balanced with 7300 chains handed, all of more than 132 tiles; the
    other 63 on the whole-tile grid: the exactly full 132-tile ones, B7's
    256 tiles of 16 row blocks (two waves of 16 against ranges of 31 or
    32), and those of at most one wave, whose cut chains would be longer
    than the ranges (B6 on panel 40: 92 tiles of 12 row blocks on ranges
    of 8 or 9)."""
    plans = [panel_apply.project_plan(m, w, 256, mr, H100_SMS, fold=True)
             for m, w, mr in _hr_launches(16384)]
    tiles = [-(-w // 128) * 2 for _, w, _ in _hr_launches(16384)]
    assert len(plans) == 123
    assert all(t > H100_SMS and t % H100_SMS for p, t in zip(plans, tiles) if p.ranges)
    assert all(p.ranges == 0 for p, t in zip(plans, tiles) if t <= H100_SMS or t == 256)
    assert sum(p.ranges > 0 for p in plans) == 60 and sum(p.handed for p in plans) == 7300
    full = panel_apply.project_plan(256 * 34, 256 * 33, 256, 512, H100_SMS, fold=True)
    assert full.groups == 1 and full.ranges == 0
    one_wave = panel_apply.project_plan(6144, 5888, 256, 512, H100_SMS, fold=True)
    assert one_wave.groups == 1 and one_wave.ranges == 0
    walk = panel_apply.project_walk(92, 12, 1, H100_SMS)
    assert any(r[0].head for r in walk) and not any(s.head and s.tail for r in walk for s in r)


def test_the_plan_reads_no_rank(monkeypatch):
    """The chooser takes shapes and an SM count only: with every way of
    asking for a rank made to raise, the plans are the same."""
    import inspect

    want = [panel_apply.project_plan(m, w, 256, mr, H100_SMS, fold=True)
            for m, w, mr in _hr_launches(4096)]

    def no_rank(*a, **k):
        raise AssertionError("the plan read a rank")

    for name in ("get_rank", "get_world_size", "is_initialized"):
        monkeypatch.setattr(torch.distributed, name, no_rank, raising=False)
    panel_apply.project_ranges.cache_clear()
    panel_apply.project_walk.cache_clear()
    assert [panel_apply.project_plan(m, w, 256, mr, H100_SMS, fold=True)
            for m, w, mr in _hr_launches(4096)] == want
    params = set(inspect.signature(panel_apply.project_plan).parameters)
    assert params == {"m", "n", "nb", "mr", "sms", "precision", "fold"}


@pytest.mark.parametrize("args", [(256, 256, 256, 512, 1, "b3", True, 2),
                                  (256, 256, 256, 512, 1, "highest", True, 3),
                                  (256, 256, 256, 512, 1, "highest", True, -1)],
                         ids=["split-mode", "past-the-units", "negative"])
def test_project_plan_at_refuses_a_schedule_it_cannot_run(args):
    with pytest.raises(ValueError, match="project_plan_at"):
        panel_apply.project_plan_at(*args)


def _emulate(y, c, mr, precision, groups, ranges):
    """Phase 1 as the balanced kernel orders it, in torch: each row block's
    partial Yᵢᵀ Cᵢ once, then the ranges in ticket order, each walking its
    segments (``project_walk``) on the fp32 tile of W: a tail starts from
    the pair the previous range handed on, a head hands its pair on, every
    other segment ends its group's pair of that tile; then the groups'
    pairs combined in group order (``combine_kernel``)."""
    tr, tc = panel_apply.PROJECT_TILES["fp32"]
    nb, n = y.shape[1], c.shape[1]
    rb = y.shape[0] // mr
    xt = -(-nb // tr)
    tiles = xt * -(-n // tc)
    groups = panel_apply._groups_at(rb, groups)
    parts = [dot_t(y[b * mr : (b + 1) * mr], c[b * mr : (b + 1) * mr], precision)
             for b in range(rb)]
    out = [[c.new_zeros((nb, n)), c.new_zeros((nb, n))] for _ in range(groups)]
    handed = {}
    for r, segs in enumerate(panel_apply.project_walk(tiles, rb, groups, ranges)):
        for s in segs:
            w = s.chain % tiles
            at = (slice((w % xt) * tr, (w % xt + 1) * tr), slice((w // xt) * tc, (w // xt + 1) * tc))
            acc, comp = handed.pop(r - 1) if s.tail else (parts[0][at] * 0, parts[0][at] * 0)
            for b in range(s.b0, s.b1):
                yk = parts[b][at] - comp
                tk = acc + yk
                comp = (tk - acc) - yk
                acc = tk
            if s.head:
                handed[r] = (acc, comp)
            else:
                out[s.chain // tiles][0][at] = acc
                out[s.chain // tiles][1][at] = comp
    assert not handed
    acc, comp = out[0]
    for a_g, c_g in out[1:]:
        yk = (a_g - c_g) - comp
        tk = acc + yk
        comp = (tk - acc) - yk
        acc = tk
    return acc


# (m, nb, n, mr, G, ranges): one group with handed chains (3 tiles, 6 row
# blocks on 4 blocks), three groups with a short last one on 7 blocks, two
# row tiles and a ragged column tile, a range inside one chain, the
# whole-tile grid (a range a chain), every unit its own range
EMULATED = [(1536, 128, 384, 256, 1, 4), (2048, 128, 384, 256, 3, 7),
            (1280, 256, 320, 256, 1, 9), (2304, 128, 256, 256, 1, 5),
            (1536, 128, 384, 256, 2, 6), (768, 128, 256, 256, 1, 6)]


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m,nb,n,mr,groups,ranges", EMULATED, ids=str)
def test_the_balanced_schedule_is_the_plain_sum_bitwise(m, nb, n, mr, groups, ranges, dt):
    y, c = (t(x) for x in inputs(m, nb, n, dt, seed=m + ranges))
    got = _emulate(y, c, mr, "highest", groups, ranges)
    want = panel_apply._project_plain(y, c, mr, "highest", groups=groups)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_counter_counts_launches_by_schedule():
    """``count_project``: a balanced launch with its chains handed, a
    whole-tile one; ``reset_counts`` clears both."""
    _build.reset_counts()
    _build.count_project(132, 128)
    _build.count_project(0, 0)
    assert _build.PROJECT == {"balanced": 1, "whole_tiles": 1, "handed": 128}
    _build.reset_counts()
    assert not any(_build.PROJECT.values())

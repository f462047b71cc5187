"""The launch plans of the strip apply K3/K4 (``kernels/chain.py:strip_plan``)
and of the whole-panel apply's phase 2 (``kernels/panel_apply.py:sub_plan``),
and the grouped plain K3 that the card's K3 is held to. On the CPU:

- both plans at the main paths' shapes (the hh path's panel 0 and late
  panels at 8192², the sharded path's ssrfb and B14 strips, the hr path's
  phase 2 on panels 0 and 60 of 16384², the tsqr cholqr2 factor's B7 at
  nb = 512, the sharded hr path's B7b slice), their invariants over every
  K3 call of the hh path, their dependence on the SM count, and their
  raises;
- ``couple_strip_plain(groups=G)``, the projections summed in the
  kernel's G row groups, against tileqr's ``couple_strip`` (with its fused
  ``larfb_strip``) in interpret mode on the same numpy inputs: float64
  relative Frobenius ≤ 1e-12, float32 ≤ 1e-5, b3/b4 ≤ 1e-5 (the groups end
  their sums in another order than the reference's single chain, so the
  two differ at the sums' rounding);
- ``groups=1`` bitwise the single chain of the plain version before groups
  existed (``_single_chain`` below), so the CPU path, which always takes
  it, is unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.kernels import chain as jchain
from tileqr.kernels import panel as jpanel
from tileqr_torch.drivers.square import _chunk_for, _segments
from tileqr_torch.kernels import chain, panel_apply
from tileqr_torch.kernels.larfb import larfb_body
from tileqr_torch.kernels.ssrfb import ssrfb_body

H100_SMS = 132
TOL = {np.float64: 1e-12, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


# ---- the plans ----

# (nb, width, rows, couples, precision, fused) → (proj tile, G, group rows,
# sub tile, workspace floats)
STRIP_CASES = {
    # hh 8192², panel 0: 7 chunk couples of 1024 rows on 7936 columns; 868
    # tiles, one group: the parent's sum order (and bits) in fp32
    "hh-panel0-chunks": ((256, 7936, 1024, 7, "highest", False),
                         ((128, 128), 1, 1024, (128, 128), 7 * 2 * 256 * 7936)),
    "hh-panel0-chunks-b3": ((256, 7936, 1024, 7, "b3", False),
                            ((128, 64), 1, 1024, (128, 64), 7 * 2 * 256 * 7936)),
    # its 3 head couples of 256 rows with the LARFB fused
    "hh-panel0-heads": ((256, 7936, 256, 3, "highest", True),
                        ((128, 128), 1, 256, (128, 128), (3 * 2 + 2) * 256 * 7936)),
    # panel 27: one couple of 1024 rows on 1024 columns; 16 large tiles, so
    # the small ones (64), and two groups of 512 rows
    "hh-panel27": ((256, 1024, 1024, 1, "highest", True),
                   ((64, 64), 2, 512, (64, 64), (1 * 3 + 2) * 256 * 1024)),
    # panel 29: two head couples of 256 rows on 512 columns, b4
    "hh-panel29-b4": ((256, 512, 256, 2, "b4", True),
                      ((64, 64), 2, 128, (64, 64), (2 * 3 + 2) * 256 * 512)),
    # panel 30: one head couple on 256 columns
    "hh-panel30": ((256, 256, 256, 1, "highest", True),
                   ((64, 64), 2, 128, (64, 64), (1 * 3 + 2) * 256 * 256)),
    # the sharded strip tree's ssrfb (one 256-row couple, 8448 columns): 132
    # large tiles fill the card
    "sharded-ssrfb": ((256, 8448, 256, 1, "highest", False),
                      ((128, 128), 1, 256, (128, 128), 2 * 256 * 8448)),
    # B14 at the sharded shape: 16 nb-row couples on 8448 columns
    "sharded-b14": ((256, 8448, 256, 16, "highest", True),
                    ((128, 128), 1, 256, (128, 128), (16 * 2 + 2) * 256 * 8448)),
    # K4 alone: no couples, the LARFB's two (nb, width) buffers
    "k4": ((256, 7936, 0, 0, "highest", True),
           ((128, 128), 1, 0, (128, 128), 2 * 256 * 7936)),
}


@pytest.mark.parametrize("case", list(STRIP_CASES), ids=str)
def test_strip_plan_at_the_main_paths_shapes(case):
    (nb, width, rows, couples, prec, fused), want = STRIP_CASES[case]
    plan = chain.strip_plan(nb, width, rows, couples, H100_SMS, prec, fused=fused)
    assert (plan.proj_tile, plan.groups, plan.group_rows, plan.sub_tile,
            plan.workspace) == want
    assert plan.slab_cols == chain.SLAB_COLS == 64


# (m, n, nb, precision, batch) → tile
SUB_CASES = {
    # B7b at the sharded hr path's slice: 2048 large tiles
    "sharded-hr-b7b": ((4096, 8192, 256, "highest", 1), (128, 128)),
    "sharded-hr-b7b-b3": ((4096, 8192, 256, "b3", 1), (128, 64)),
    # B6 phase 2 on panel 0 of the 16384² hr path
    "hr-panel0": ((16384, 16128, 256, "highest", 1), (128, 128)),
    # B6 phase 2 on panel 60: 48 large tiles leave most of the card idle
    "hr-panel60": ((1024, 768, 256, "highest", 1), (64, 64)),
    "hr-panel60-default": ((1024, 768, 256, "default", 1), (64, 64)),
    # the tsqr cholqr2 factor's B7 at nb = 512: 8192 x 8 tiles
    "tsqr-factor-b3": ((1048576, 512, 512, "b3", 1), (128, 64)),
    # K3's stage 3 at hh panel 0: 7 couples of 1024 rows stacked
    "hh-panel0-stage3": ((1024, 7936, 256, "highest", 7), (128, 128)),
    # one couple of 1024 rows on 1024 columns (hh panel 27)
    "hh-panel27-stage3": ((1024, 1024, 256, "highest", 1), (64, 64)),
}


@pytest.mark.parametrize("case", list(SUB_CASES), ids=str)
def test_sub_plan_at_the_main_paths_shapes(case):
    (m, n, nb, prec, batch), tile = SUB_CASES[case]
    assert panel_apply.sub_plan(m, n, nb, H100_SMS, prec, batch).tile == tile


def test_high_takes_the_split_tiles():
    assert panel_apply.sub_plan(4096, 8192, 256, H100_SMS, "high").tile == (128, 64)
    assert chain.strip_plan(256, 7936, 1024, 7, H100_SMS, "high").proj_tile == (128, 64)


def _hh_calls(n, nb, chunk=4):
    """(rows, couples, width, fused) of every K3 call of the hh factor of
    an n² A (the head couples, then the chunks)."""
    mt = n // nb
    c = _chunk_for(mt, chunk)
    out = []
    for k in range(mt - 1):
        n_head, _, nc = _segments(k, mt, c)
        width = n - (k + 1) * nb
        if n_head:
            out.append((nb, n_head, width, True))
        if nc:
            out.append((c * nb, nc, width, not n_head))
    return out


@pytest.mark.parametrize("prec", ["highest", "b3", "default"])
@pytest.mark.parametrize("n", [4096, 8192])
def test_strip_plan_invariants_on_the_hh_path(prec, n):
    """Every K3 call of the n² hh factor: the small proj tile only where the
    large tiles leave the card partly idle; G = 1 where the tiles take more
    than half the card, else the tiles times G at most the card; whole
    32-row groups, none empty; the workspace its buffers."""
    nb = 256
    large, small = panel_apply.tiles_for(prec)
    for rows, couples, width, fused in _hh_calls(n, nb):
        plan = chain.strip_plan(nb, width, rows, couples, H100_SMS, prec, fused=fused)
        big_tiles = panel_apply.tile_count(nb, width, large, couples)
        assert plan.proj_tile == (large if big_tiles >= H100_SMS else small)
        tiles = panel_apply.tile_count(nb, width, plan.proj_tile, couples)
        if tiles * 2 > H100_SMS:
            assert plan.groups == 1
        else:
            assert tiles * plan.groups <= H100_SMS
        assert plan.group_rows % chain.GROUP_ALIGN == 0
        assert (plan.groups - 1) * plan.group_rows < rows <= plan.groups * plan.group_rows
        assert plan.groups == 1 or plan.group_rows >= chain.GROUP_MIN_ROWS
        assert plan.sub_tile == panel_apply.sub_plan(rows, width, nb, H100_SMS, prec,
                                                     couples).tile
        plane = nb * width
        assert plan.workspace == couples * (plan.groups + 1) * plane + (2 * plane if fused else 0)


def test_plans_follow_the_sm_count():
    """A card of more SMs takes the small tiles and more groups sooner; one
    of a single SM the large tiles and one group."""
    assert chain.strip_plan(256, 7936, 1024, 7, 1, "highest").groups == 1
    assert chain.strip_plan(256, 7936, 1024, 7, 10000, "highest").proj_tile == (64, 64)
    assert chain.strip_plan(256, 7936, 1024, 7, 10000, "highest").groups == 2
    assert chain.strip_plan(256, 1024, 1024, 1, 1, "highest").proj_tile == (128, 128)
    assert chain.strip_plan(256, 1024, 1024, 1, 1, "highest").groups == 1
    assert panel_apply.sub_plan(1024, 768, 256, 48, "highest").tile == (128, 128)
    assert panel_apply.sub_plan(1024, 768, 256, 49, "highest").tile == (64, 64)
    assert panel_apply.sub_plan(4096, 8192, 256, 4096, "b3").tile == (128, 64)
    assert panel_apply.sub_plan(4096, 8192, 256, 4097, "b3").tile == (64, 64)


def test_strip_counter_keys_by_plan_and_is_cleared_by_reset_counts():
    """``_build.STRIP``: K3 launches by (stage-1 tile, G, stage-3 tile) with
    the couples they swept."""
    from tileqr_torch.kernels import _build

    _build.reset_counts()
    wide = chain.strip_plan(256, 7936, 1024, 7, H100_SMS, "highest")
    narrow = chain.strip_plan(256, 256, 1024, 7, H100_SMS, "highest")
    key = lambda p: (p.proj_tile, p.groups, p.sub_tile)  # noqa: E731
    for plan, couples in ((wide, 7), (wide, 7), (narrow, 7), (narrow, 0)):
        _build.count_strip(key(plan), couples)
    assert key(wide) != key(narrow)
    assert _build.STRIP == {key(wide): {"launches": 2, "couples": 14},
                            key(narrow): {"launches": 2, "couples": 7}}
    _build.reset_counts()
    assert _build.STRIP == {}


def test_group_rows_are_whole_stages():
    assert chain.group_rows(1024, 1) == 1024
    assert chain.group_rows(1024, 3) == 352  # ceil(1024 / 3) = 342 → 11 stages
    assert chain.group_rows(256, 7) == 64    # ceil(256 / 7) = 37 → 2 stages: 4 groups
    assert chain.group_rows(40, 2) == 32


@pytest.mark.parametrize("args", [(0, 256, 256, 1, 132), (256, 0, 256, 1, 132),
                                  (256, 256, 256, 1, 0), (256, 256, 256, -1, 132),
                                  (256, 256, 0, 1, 132)], ids=str)
def test_strip_plan_raises(args):
    with pytest.raises(ValueError, match="strip_plan"):
        chain.strip_plan(*args)


@pytest.mark.parametrize("args", [(0, 256, 256, 132), (256, 0, 256, 132), (256, 256, 0, 132),
                                  (256, 256, 256, 0)], ids=str)
def test_sub_plan_raises(args):
    with pytest.raises(ValueError, match="sub_plan"):
        panel_apply.sub_plan(*args)
    with pytest.raises(ValueError, match="precision"):
        panel_apply.sub_plan(256, 256, 256, 132, "fp8")


# ---- the grouped plain K3 against tileqr ----

NB = 64  # couples of 2·nb = 128 rows: G = 2 (64-row groups) or 4 (32-row groups)


class Case:
    """A (6nb, 3nb) with K1 (one head couple) and K2 (two chunk couples of
    2nb rows) from tileqr in interpret mode."""

    def __init__(self, dt):
        self.dt = dt
        self.a = np.random.default_rng(7).standard_normal((6 * NB, 3 * NB)).astype(dt)
        ja = jnp.asarray(self.a)
        self.k1 = [np.asarray(x) for x in jpanel.panel_factor(
            ja, 0, NB, ib=NB // 2, n_couples=1, interpret=True)]
        self.k2 = [np.asarray(x) for x in jchain.panel_chain(
            ja, jnp.asarray(self.k1[0]), 0, NB, 1, 2, 2 * NB, ib=NB // 2, interpret=True)]
        self.want = {}

    def t(self, x):
        return torch.tensor(np.asarray(x), dtype=TORCH[self.dt])

    def reference(self, trans, reverse, mode):
        """tileqr's fused couple_strip on the two chunk couples (cached)."""
        key = (trans, reverse, mode)
        if key not in self.want:
            _, v_stack, tg, _ = self.k1
            _, v_chunks, t2 = self.k2
            jc, js = jchain.couple_strip(
                jnp.asarray(v_chunks), jnp.asarray(t2), jnp.asarray(self.a),
                jnp.asarray(self.a[:NB, NB:]), 0, 1, 2, 2 * NB, NB, 1, trans=trans,
                reverse=reverse, vkk=jnp.asarray(v_stack[0]), tg=jnp.asarray(tg),
                precision=mode, interpret=True)
            self.want[key] = (np.asarray(js), np.asarray(jc)[2 * NB :])
        return self.want[key]

    def port(self, trans, reverse, mode, groups, plain=chain.couple_strip_plain):
        _, v_stack, tg, _ = self.k1
        _, v_chunks, t2 = self.k2
        c = self.t(self.a)
        strip = c[:NB, NB:]
        kw = {} if groups is None else {"groups": groups}
        plain(self.t(v_chunks), self.t(t2), c, strip, 0, 1, 2, 2 * NB, NB, 1, trans=trans,
              reverse=reverse, vkk=self.t(v_stack[0]), tg=self.t(tg), precision=mode, **kw)
        return strip, c[2 * NB :]


@pytest.fixture(scope="module")
def cases():
    return {dt: Case(dt) for dt in (np.float64, np.float32)}


VARIANTS = [(True, False), (False, True)]  # the factor's sweep, the Q sweep


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("trans,reverse", VARIANTS, ids=["trans-fwd", "notrans-rev"])
@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
def test_grouped_plain_k3_matches_tileqr(cases, dt, trans, reverse, groups):
    case = cases[dt]
    assert -(-2 * NB // chain.group_rows(2 * NB, groups)) == groups
    got = case.port(trans, reverse, "highest", groups)
    want = case.reference(trans, reverse, "highest")
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL[dt], rel(g, w)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("mode", ["b3", "b4"])
def test_grouped_plain_k3_modes_match_tileqr(cases, mode, groups):
    case = cases[np.float32]
    got = case.port(True, False, mode, groups)
    want = case.reference(True, False, mode)
    hi = case.port(True, False, "highest", groups)
    for g, w, h in zip(got, want, hi):
        assert rel(g, w) <= 1e-5, (mode, rel(g, w))
        assert rel(g, w) < rel(h, w)  # nearer the reference's mode than fp32


def _single_chain(v_stack, t2_stack, c, strip, stack_base, base_block, n_chunks, block_rows,
                  nb, col_start, trans, reverse, vkk, tg, precision):
    """The plain K3 as it was before groups: one projection chain a couple."""
    c0 = col_start * nb
    s = strip
    if vkk is not None and not reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    for ii in (range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)):
        r0 = (base_block + ii) * block_rows
        bot = c[r0 : r0 + block_rows, c0:]
        s, new_bot = ssrfb_body(v_stack[stack_base + ii], t2_stack[stack_base + ii], s, bot,
                                trans, precision)
        bot.copy_(new_bot)
    if vkk is not None and reverse:
        s = larfb_body(vkk, tg, s, trans, precision)
    if s is not strip:
        strip.copy_(s)
    return c, strip


@pytest.mark.parametrize("mode", ["highest", "b3"])
@pytest.mark.parametrize("trans,reverse", VARIANTS, ids=["trans-fwd", "notrans-rev"])
def test_one_group_is_the_single_chain_bitwise(cases, trans, reverse, mode):
    case = cases[np.float32]
    for groups in (None, 1):
        got = case.port(trans, reverse, mode, groups)
        want = case.port(trans, reverse, mode, None, plain=_single_chain)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_grouped_plain_k3_raises_on_no_groups(cases):
    with pytest.raises(ValueError, match="groups"):
        cases[np.float64].port(True, False, "highest", 0)


# ---- stage 2's row bands (``chain.chain_bands``, ``_build.CHAIN``) ----

# strip widths at nb = 256 → the chain's row bands a 64-column block on the
# H100: 4 while 4 CTAs a block fit the 132 SMs (33 blocks, 2112 columns),
# then 2 (66 blocks, 4224 columns), then 1
BAND_CASES = {
    "narrow-update": (256, 4),   # every narrow update, Q's last sweeps
    "q-sweep-1024": (1024, 4),
    "rest-2112": (2112, 4),      # 33 blocks: 132 CTAs
    "rest-2176": (2176, 2),      # 34 blocks
    "rest-4224": (4224, 2),      # 66 blocks: 132 CTAs
    "rest-4352": (4352, 1),
    "rest-7680": (7680, 1),      # the first 8192² rest
    "panel0-7936": (7936, 1),
    "q-sweep-8192": (8192, 1),
    "rest-15872": (15872, 1),    # the first 16384² update
}


@pytest.mark.parametrize("case", list(BAND_CASES), ids=str)
def test_chain_bands_at_the_cells_widths(case):
    width, bands = BAND_CASES[case]
    assert chain.chain_bands(256, width, H100_SMS) == bands
    for couples, rows, fused in ((0, 0, True), (3, 256, True), (7, 1024, False)):
        for prec in ("highest", "b3"):
            plan = chain.strip_plan(256, width, rows, couples, H100_SMS, prec, fused=fused)
            assert plan.bands == bands


@pytest.mark.parametrize("n", [8192, 16384])
def test_chain_bands_on_every_k3_call_of_the_cells(n):
    """Every K3 call of an n² ``qr`` (the factor's narrow and rest updates,
    Q's sweeps): the most of 4, 2, 1 whose CTAs fit the card; so 4 on every
    narrow update and 1 on every strip of more than 66 blocks."""
    nb, mt = 256, n // 256
    c = _chunk_for(mt, 4)
    widths = []
    for k in range(mt - 1):
        left = mt - k - 1
        widths.append((nb if left >= 2 else left * nb, "narrow"))
        if left >= 2:
            widths.append(((left - 1) * nb, "rest"))
    widths += [((mt - k) * nb, "q") for k in range(mt)]
    for width, kind in widths:
        blocks = -(-width // 64)
        bands = chain.chain_bands(nb, width, H100_SMS)
        assert bands == max(b for b in (1, 2, 4) if b == 1 or blocks * b <= H100_SMS)
        if kind == "narrow":
            assert bands == 4
        if blocks > 66:
            assert bands == 1
    assert {k for _, k in widths} == {"narrow", "rest", "q"} and c == 4


@pytest.mark.parametrize("nb,want", [(8, 1), (64, 1), (96, 1), (128, 2), (192, 2), (256, 4),
                                     (320, 4), (512, 4)], ids=str)
def test_chain_bands_need_whole_64_row_tiles(nb, want):
    """More than one band only where nb is whole 64-row tiles and each CTA
    gets one at least: the most that fits at any SM count."""
    assert chain.chain_bands(nb, 256, H100_SMS) == want
    assert chain.chain_bands(nb, 256, 4) == 1  # 4 blocks take the card
    assert chain.band_rows(nb, want) == (128 if nb >= 128 * want else 64)


def test_chain_bands_follow_the_sm_count():
    assert chain.chain_bands(256, 256, 16) == 4
    assert chain.chain_bands(256, 512, 16) == 2
    assert chain.chain_bands(256, 768, 16) == 1
    assert chain.chain_bands(256, 7936, 10000) == 4


@pytest.mark.parametrize("bands", [1, 2, 4])
@pytest.mark.parametrize("couples,rows,fused", [(0, 0, True), (2, 256, True), (7, 1024, False)])
def test_strip_workspace_is_the_same_at_every_band_count(bands, couples, rows, fused):
    plan = chain.strip_plan_at(256, 256, rows, couples, (64, 64), 2, (64, 64), fused, bands)
    one = chain.strip_plan_at(256, 256, rows, couples, (64, 64), 2, (64, 64), fused)
    assert plan.bands == bands and one.bands == 1
    assert plan.workspace == one.workspace == chain.strip_workspace(256, 256, couples,
                                                                    plan.groups, fused)
    assert plan._replace(bands=1) == one


@pytest.mark.parametrize("nb,bands", [(256, 3), (256, 8), (128, 4), (64, 2), (200, 2)],
                         ids=str)
def test_strip_plan_at_refuses_bands_the_kernel_lacks(nb, bands):
    with pytest.raises(ValueError, match="bands"):
        chain.strip_plan_at(nb, 256, 256, 1, (64, 64), 1, (64, 64), False, bands)


def test_chain_counter_keys_by_bands_and_is_cleared_by_reset_counts():
    """``_build.CHAIN``: K3's chain launches by row bands with the couples
    they swept; ``STRIP``'s keys stay the plan's tiles and G."""
    from tileqr_torch.kernels import _build

    _build.reset_counts()
    for bands, couples in ((4, 3), (4, 7), (1, 7), (2, 1)):
        _build.count_chain(bands, couples)
    assert _build.CHAIN == {4: {"launches": 2, "couples": 10}, 1: {"launches": 1, "couples": 7},
                            2: {"launches": 1, "couples": 1}}
    _build.reset_counts()
    assert _build.CHAIN == {} and _build.STRIP == {}


# ``planned_hh_counts``' CHAIN of the cells' ``qr`` at 132 SMs: bands 4 on
# the 31 (63) narrow updates' K3 calls, Q's late sweeps and the rests of
# 2112 columns or fewer, 2 on the rests and sweeps of 2176-4224 columns, 1
# on the wider ones; the same calls as STRIP's 155 (323)
CELL_CHAIN = {
    8192: {4: {"launches": 74, "couples": 196}, 2: {"launches": 28, "couples": 68},
           1: {"launches": 53, "couples": 215}},
    16384: {4: {"launches": 130, "couples": 612}, 2: {"launches": 28, "couples": 68},
            1: {"launches": 165, "couples": 1047}},
}


@pytest.mark.parametrize("n", list(CELL_CHAIN))
def test_chain_counts_derived_at_the_cells(n):
    import _hh_counts

    want = _hh_counts.planned_hh_counts(n, 256, 128, 4, H100_SMS)
    assert want["chain"] == CELL_CHAIN[n]
    for key in ("launches", "couples"):
        assert (sum(e[key] for e in want["chain"].values())
                == sum(e[key] for e in want["strip"].values()))


@pytest.fixture
def stub_card_16(monkeypatch):
    """The wrappers' card side on CPU tensors (a stubbed kernel library) at
    16 SMs, where a 2048² ``qr`` at nb = 256 takes every band count."""
    from tests.test_torch_cluster_plan import StubLib
    from tileqr_torch.kernels import _build

    monkeypatch.setattr(_build, "is_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", StubLib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: 16)
    _build.reset_counts()
    yield _build
    _build.reset_counts()


def test_chain_counter_is_what_the_plans_give(stub_card_16):
    import _hh_counts
    import tileqr_torch

    _build = stub_card_16
    tileqr_torch.qr(torch.zeros((2048, 2048)), config=tileqr_torch.QRConfig(nb=256, ib=128,
                                                                            chunk=4))
    want = _hh_counts.planned_hh_counts(2048, 256, 128, 4, 16)
    assert _build.CHAIN == want["chain"] and _build.STRIP == want["strip"]
    assert set(_build.CHAIN) == {1, 2, 4}
    _build.reset_counts()
    assert _build.CHAIN == {}

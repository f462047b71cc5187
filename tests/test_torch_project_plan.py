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
  always takes it, is unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.kernels import panel_apply as jpa
from tileqr_torch.kernels import panel_apply
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

# (m, n, nb, mr, precision, fold) → (tile, G, workspace floats)
PLAN_CASES = {
    # B7a, rank (0, 0)'s segment-0 slice of the 16384² sharded hr path
    "b7a-fp32": ((4096, 8192, 256, 512, "highest", False), ((128, 128), 1, 0)),
    "b7a-b3": ((4096, 8192, 256, 512, "b3", False), ((128, 64), 1, 0)),
    "b7a-default": ((4096, 8192, 256, 512, "default", False), ((128, 64), 1, 0)),
    # B6, panel 0 of the 16384² hr path: 252 tiles, one group; the fold
    # reads W's pair from the workspace
    "b6-panel0": ((16384, 16128, 256, 512, "highest", True), ((128, 128), 1, 2 * 256 * 16128)),
    # B6, panel 48: 60 tiles leave 72 SMs, two groups of the 8 row blocks
    "b6-panel48": ((4096, 3840, 256, 512, "highest", True), ((128, 128), 2, 2 * 2 * 256 * 3840)),
    # B6, panel 62: one row block, so one group however idle the card
    "b6-panel62": ((512, 256, 256, 512, "highest", True), ((128, 128), 1, 2 * 256 * 256)),
    # B7 in b3 of the tsqr cholqr2 factor (1048576 × 512, nb = 512, mr =
    # 1024): 32 tiles, four groups of 256 row blocks
    "tsqr-factor-b3": ((1048576, 512, 512, 1024, "b3", True), ((128, 64), 4, 4 * 2 * 512 * 512)),
    # a narrow bare sum: 4 tiles, 32 row blocks, every block its own group
    "narrow": ((16384, 256, 256, 512, "highest", False), ((128, 128), 32, 32 * 2 * 256 * 256)),
    # 32 tiles leave room for 4 groups of 5 row blocks: ceil(5 / 4) = 2 blocks
    # a group, so 3 groups
    "uneven": ((2560, 1024, 256, 512, "b4", False), ((128, 64), 3, 3 * 2 * 256 * 1024)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=str)
def test_project_plan_at_the_main_paths_shapes(case):
    (m, n, nb, mr, prec, fold), (tile, groups, work) = PLAN_CASES[case]
    plan = panel_apply.project_plan(m, n, nb, mr, H100_SMS, prec, fold=fold)
    assert plan == (tile, groups, work)


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
        assert plan.workspace == plan.groups * 2 * nb * w


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

"""Tall-skinny TSQR tree driver (counterpart of ``tileqr/drivers/tsqr.py``).

An (M, n) panel is cut into ``leaf_rows``-row leaves; every leaf is
GEQRT-factored by one launch of the batched GEQRT kernel (``tall_geqrt``,
B10, on the stack ``a.view(p, leaf_rows, n)``); then each tree level stacks
up to ``arity`` surviving R factors and runs the same kernel on the
(a·n, n) stacks, until one R is left. The leaf size (``auto_leaf_rows``)
and the tree shape (``_tree_plan``) are the reference's, copied exactly, so
``TSQRFactors`` have the JAX layout and move between the packages
(``interop.tsqr_factors_to_numpy`` / ``tsqr_factors_from_numpy``).

Applying Q replays the leaves, then the levels, as compact-WY products
(the reference's ``larfb_body`` with its ``vmap`` written out as a batch
dimension). The JAX package left these products to XLA; here they are
``torch.matmul`` with TF32 off (``cholqr._highest``, the pin of the hr
driver), except that W = VᵀC, a contraction over a leaf's or a stack's
rows, is summed in float64 (``_larfb``). In another precision mode the
apply runs ``larfb_body`` in the mode's product, as the reference's does;
forming Q raises in "b3"/"b4" where the reference's XLA products do
(``common.refuse_xla_site``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from tileqr_torch.core.trace import span
from tileqr_torch.drivers.cholqr import _highest
from tileqr_torch.kernels.common import passes_of, refuse_xla_site, unit_lower
from tileqr_torch.kernels.geqrt import geqrt_batched
from tileqr_torch.kernels.larfb import larfb_body


class TSQRFactors(NamedTuple):
    """packed_leaves: (M, n) leaf reflectors (packed GEQRT form per leaf);
    t_leaves: (p, n, n) leaf compact-WY T factors; levels: per tree level
    (packed (ncomb, a·n, n), t (ncomb, n, n), survivors_before, arity);
    r: (n, n) final factor; shape: the factored (padded) (M, n); plan: the
    ``_tree_plan`` of the tree, parallel to ``levels``."""

    packed_leaves: torch.Tensor
    t_leaves: torch.Tensor
    levels: Tuple
    r: torch.Tensor
    leaf_rows: int
    shape: Tuple[int, int]
    plan: Tuple


# the reference's VMEM budget for its transposed leaf scratch: kept so that
# the leaves, and so the factors' layout, are the JAX package's
_SCRATCH_BYTES = 4 * 1024 * 1024


def auto_leaf_rows(m: int, n: int) -> int:
    """Largest leaf whose (n, leaf_rows) fp32 scratch is within 4 MiB,
    floored at 2n (the tree needs a leaf to hold two stacked R factors),
    128-aligned where possible, a multiple of 8, at most m."""
    target = max(2 * n, _SCRATCH_BYTES // (n * 4))
    target -= target % 128 if target >= 128 else target % 8
    target = max(target, 2 * n)
    if target % 8:
        target += 8 - target % 8
    return max(8, min(m, target))


def tall_geqrt(a: torch.Tensor, leaf_rows: int, ib: int = 128):
    """Factor every ``leaf_rows``-row block of a (M, n), M % leaf_rows == 0.
    Returns (packed (M, n), T (p, n, n))."""
    m, n = a.shape
    if m % leaf_rows:
        raise ValueError(f"M={m} not a multiple of leaf_rows={leaf_rows}")
    packed, t = geqrt_batched(a.reshape(m // leaf_rows, leaf_rows, n), ib)
    return packed.reshape(m, n), t


def _tree_plan(p: int, n: int, leaf_rows: int, arity: int):
    """Static tree: per level (groups, a_l, flat_idx, rem_idx) over ORIGINAL
    leaf indices; survivors stay ascending (group reps then remainder)."""
    a_cap = max(2, min(arity, leaf_rows // n))
    levels = []
    idx = list(range(p))
    while len(idx) > 1:
        a_l = min(a_cap, len(idx))
        ncomb = len(idx) // a_l
        flat = idx[: ncomb * a_l]
        rem = idx[ncomb * a_l :]
        reps = flat[::a_l]
        levels.append((ncomb, a_l, tuple(flat), tuple(rem)))
        idx = sorted(reps + rem)
    return levels


def tsqr_factor(a: torch.Tensor, nb: int, ib: int = 128, leaf_rows: Optional[int] = None,
                arity: int = 8) -> TSQRFactors:
    """TSQR-factor a tall-skinny A (M, n) with n <= nb, M % leaf_rows == 0
    (leaf_rows defaults to ``auto_leaf_rows``; ``api.tsqr`` pads M)."""
    m, n = a.shape
    if n > nb:
        raise ValueError(f"tsqr requires n={n} <= nb={nb}")
    lr = leaf_rows if leaf_rows is not None else auto_leaf_rows(m, n)
    if m % lr:
        raise ValueError(f"M={m} not a multiple of leaf_rows={lr}")
    p = m // lr
    if p > 1 and lr < 2 * n:
        raise ValueError(f"tree needs leaf_rows={lr} >= 2n={2 * n}")
    ib_eff = min(ib, n)
    with span("tileqr_torch.tree.leaves"):
        packed, ts = tall_geqrt(a, lr, ib=ib_eff)
        rs = torch.triu(packed.reshape(p, lr, n)[:, :n, :])

    plan = _tree_plan(p, n, lr, arity)
    levels: List = []
    for ncomb, a_l, flat, rem in plan:
        with span("tileqr_torch.tree.level"):
            # rs rows follow the current survivor list: group reps, then the rest
            stack = rs[: ncomb * a_l].reshape(ncomb * a_l * n, n)
            pk, tl = tall_geqrt(stack, a_l * n, ib=ib_eff)
            pk = pk.reshape(ncomb, a_l * n, n)
            rnew = torch.triu(pk[:, :n, :])
            rs = torch.cat([rnew, rs[ncomb * a_l :]]) if rem else rnew
        levels.append((pk, tl, ncomb * a_l + len(rem), a_l))
    return TSQRFactors(packed, ts, tuple(levels), rs[0], lr, (m, n), tuple(plan))


def _larfb(packed: torch.Tensor, t: torch.Tensor, c: torch.Tensor, trans: bool,
           precision: str = "highest") -> torch.Tensor:
    """C ← (I − V T Vᵀ)^{T if trans} C for a stack, V = unit_lower(packed).
    In "highest", W = VᵀC is summed in float64 and rounded once to C's
    dtype. That sum runs over 2048 rows at 1048576×512 (up to 131072 in a
    leaf), and in fp32 it alone put the fp32 ``apply_q`` relerr
    ‖QᵀA − R‖F/‖A‖F at 2.1e-6 on an H100, against 6.3e-7 this way
    (PERF.md). The H100's float64 matmul rate is its fp32 rate, so it costs
    the conversions only. Other modes: ``larfb_body`` in the mode's
    product (round-to-nearest split, as the reference's)."""
    if passes_of(precision):
        return larfb_body(packed, t, c, trans, precision)
    v = unit_lower(packed)
    w = (v.transpose(-2, -1).double() @ c.double()).to(c.dtype)
    w = (t.transpose(-2, -1) if trans else t) @ w
    return c - v @ w


def _level_apply(tops: torch.Tensor, level, pk: torch.Tensor, tl: torch.Tensor,
                 trans: bool, precision: str = "highest") -> None:
    """One tree level's block reflectors on the stacked top blocks, in place."""
    ncomb, a_l, flat, _ = level
    n, pcols = tops.shape[1:]
    with span("tileqr_torch.sync.tree_index"):  # a copy from a Python list
        gather = torch.tensor(flat, device=tops.device)
    stack = tops[gather].reshape(ncomb, a_l * n, pcols)
    tops[gather] = _larfb(pk, tl, stack, trans, precision).reshape(ncomb * a_l, n, pcols)


def tsqr_apply_q(f: TSQRFactors, c: torch.Tensor, trans: bool = True,
                 precision: str = "highest") -> torch.Tensor:
    """Qᵀ C (trans) or Q C for the TSQR Q, in the precision mode. c: (Mc, P)
    with Mc <= f.shape[0], in the caller's row count: the rows the
    factorization padded are zero rows of the factored input, on which Q
    and Qᵀ act as the identity."""
    m, n = f.shape
    lr = f.leaf_rows
    p = m // lr
    mc, pcols = c.shape
    if mc > m:
        raise ValueError(f"c rows {mc} > factored M {m}")
    cb = c.new_zeros((p, lr, pcols))
    cb.view(m, pcols)[:mc] = c
    leaves = f.packed_leaves.reshape(p, lr, n)
    with _highest():
        if trans:
            cb = _larfb(leaves, f.t_leaves, cb, True, precision)
            for level, (pk, tl, _cnt, _a) in zip(f.plan, f.levels):
                _level_apply(cb[:, :n, :], level, pk, tl, True, precision)
        else:
            for level, (pk, tl, _cnt, _a) in zip(f.plan[::-1], f.levels[::-1]):
                _level_apply(cb[:, :n, :], level, pk, tl, False, precision)
            cb = _larfb(leaves, f.t_leaves, cb, False, precision)
    return cb.reshape(m, pcols)[:mc]


def tsqr_form_q(f: TSQRFactors, precision: str = "highest") -> torch.Tensor:
    """Reduced Q (M, n) without an M×n identity: the levels act on (p, n, n)
    top blocks seeded with I_n at the root only, and the leaf apply uses
    C = [top; 0]: Q_leaf C = C − V T (V₁ᵀ top). fp32 products in every
    mode; "b3"/"b4" raise, as the reference's leaf products do."""
    refuse_xla_site(precision, "tsqr_form_q (the tree's reduced Q)")
    m, n = f.shape
    lr = f.leaf_rows
    p = m // lr
    tops = f.packed_leaves.new_zeros((p, n, n))
    tops[0] = torch.eye(n, dtype=tops.dtype, device=tops.device)
    with _highest():
        for level, (pk, tl, _cnt, _a) in zip(f.plan[::-1], f.levels[::-1]):
            _level_apply(tops, level, pk, tl, False)
        v = unit_lower(f.packed_leaves.reshape(p, lr, n))
        w = f.t_leaves @ (v[:, :n].transpose(1, 2) @ tops)
        q = -(v @ w)
    q[:, :n] += tops
    return q.reshape(m, n)

"""GEQRT: the Householder column loop as plain torch, and the batched
GEQRT kernel's wrappers.

``geqrt_in_place`` is the counterpart of
``tileqr/kernels/geqrt.py:geqrt_in_refs``, the column loop inside every
panel kernel. It mirrors the JAX algebra step by step, on the same
transposed layout (row j of ``at`` is column j of A), so that the two agree
to rounding in float64:

- LARFG with no rescaling: sgn = +1 when alpha >= 0, beta = -sgn·‖x‖,
  tau = (beta-alpha)/beta, v = x·(1/(alpha-beta)); with no tail below the
  diagonal, tau = 0 and beta = alpha;
- rank-1 updates confined to the current ib-column block;
- the block's T built after its column loop from the gram G = VᵀV by the
  doubling recurrence T ← T − T(G⊙M)T;
- one block-reflector apply to the columns right of the block;
- the off-diagonal T, −T1(V1ᵀV2)T2.

The CUDA device routine with the same contract is ``csrc/geqrt.cuh``; the
panel kernels (``panel.py``, ``chain.py``) call it on the card and
``geqrt_in_place`` on the CPU. On the card K1, K2, TTQRT and the batched
cluster route run it as one thread-block cluster
(``csrc/geqrt_cluster.cuh``), whose plan lives here: ``cluster_plan_at``
holds the rule at C CTAs (the active block resident in shared memory where
it fits), ``cluster_plan`` picks C for K1/K2.

This module also holds the batched GEQRT (``geqrt_batched``), the port of
four TPU kernels that compute the same function, GEQRT of every matrix of
a stack with inner block width ``ib`` (packed reflectors and T):
``tileqr/drivers/batched.py:geqrt_batched`` (one matrix per grid step),
``batched.py:geqrt_batched_grouped`` (G matrices per grid step),
``tileqr/drivers/tsqr.py:tall_geqrt`` (every leaf of a tall matrix, and the
tree's stacked R factors) and ``tileqr/kernels/geqrt.py:geqrt`` (B = 1).
On a CUDA tensor it takes one of four routes, which ``batched_plan``
picks from the shapes and the SM count: a matrix whose tile fits one
CTA's shared memory the small route ``tq_geqrt_small``
(``csrc/geqrt_small.cu``, a CTA a matrix, several an SM: ``qr_batched``'s
stacks, B11 and B16), counted as ``geqrt_batched[small]``; a stack small
enough that B clusters fill the card the cluster route
``tq_geqrt_batched_cluster`` (one thread-block cluster a matrix,
``csrc/geqrt_cluster.cuh``: B1s at 256² and the tsqr tree's levels of ≤ 32
stacks), counted as ``geqrt_batched[cluster]``; a stack of m ≥ n whose
narrow panels fit one CTA's shared memory the tall route
``tq_geqrt_tall`` (``csrc/geqrt_tall.cu``, a persistent CTA a matrix,
``tall_plan`` and ``tall_schedule``: the tsqr leaves and the tree's level
of 128 stacks), counted as ``geqrt_batched[tall]``; any other stack
``tq_geqrt_batched`` (``csrc/geqrt_batched.cu``, one block a matrix, its
tile in global memory: m < n past the small route). On a CPU tensor it
runs ``geqrt_batched_plain``. The routes sum in other orders, so a
matrix's bits depend on the route, which depends on B. The small and tall
routes build T by the column recurrence (``t_from_gram``) and joins where
the plain version doubles: they agree to rounding.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from tileqr_torch.core.trace import span
from tileqr_torch.kernels import _build

# a matrix of 4·(m·n + n·n + m) bytes up to this takes the small route (its
# tile, T and a few columns in one CTA's shared memory)
_SMALL_MAX_BYTES = 200 * 1024
# threads of a small-route CTA (one a matrix; small_threads), of a tall-route
# CTA (csrc/geqrt_tall.cu: tile_gemm.cuh's F_THREADS), and of the one-block
# kernel's block (csrc/geqrt.cuh: GEQRT_THREADS)
SMALL_THREADS = 256
TALL_THREADS = 256
GLOBAL_THREADS = 1024
# the launch counter of each route
ROUTE_KEYS = {"small": "geqrt_batched[small]", "cluster": "geqrt_batched[cluster]",
              "tall": "geqrt_batched[tall]", "global": "geqrt_batched"}


def _recon_vt(rows: torch.Tensor, row0: int, lane_r: torch.Tensor) -> torch.Tensor:
    """Vᵀ rows [row0, row0+nrows) from the packed rows of ``at``."""
    gid = row0 + torch.arange(rows.shape[-2], device=rows.device)[:, None]
    one = torch.ones((), dtype=rows.dtype, device=rows.device)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return torch.where(lane_r == gid, one, torch.where(lane_r > gid, rows, zero))


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-2, -1)


def geqrt_in_place(at: torch.Tensor, tt: torch.Tensor, kcols: int, ib: int,
                   tri_bottom: bool = False) -> None:
    """Factor the tile held transposed in ``at`` (..., n, m) in place, every
    matrix of the leading dimensions at once.

    On exit ``at`` holds packedᵀ (R on and above the diagonal of A, the v's
    below) and ``tt`` (..., n, n, zeroed on entry) holds Tᵀ.

    tri_bottom: the tile is the TTQRT couple [R1; R2] with R2 (rows
    n..2n-1) upper triangular, so once the column block ending at column e
    is reached only its first n + e rows can be non-zero (tileqr's
    ``lane_extent``): every step of that block runs on those rows only
    (``csrc/ttqrt.cu`` walks a subset of them, the block's live rows).
    Default: all m rows.
    """
    n, m = at.shape[-2:]
    dt, dev = at.dtype, at.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    lane_t = torch.arange(n, device=dev)

    for s in range(0, kcols, ib):
        ibk = min(ib, kcols - s)
        wl = min(m, n + s + ibk) if tri_bottom else m
        lane_r = torch.arange(wl, device=dev)
        sub_b = torch.arange(ibk, device=dev)[:, None]
        for jj in range(ibk):
            j = s + jj
            x = at[..., j, :wl].clone()  # (..., wl)
            alpha = x[..., j : j + 1]
            tailsq = torch.where(lane_r > j, x * x, zero).sum(dim=-1, keepdim=True)
            sgn = torch.where(alpha >= 0, one, -one)
            nrm = torch.sqrt(alpha * alpha + tailsq)
            has_tail = tailsq > 0
            beta = torch.where(has_tail, -sgn * nrm, alpha)
            tau = torch.where(has_tail, (beta - alpha) / beta, zero)
            scale = torch.where(has_tail, 1 / (alpha - beta), zero)
            v = torch.where(lane_r == j, one, torch.where(lane_r > j, x * scale, zero))

            blk = at[..., s : s + ibk, :wl]
            w = (blk * v[..., None, :]).sum(dim=-1, keepdim=True)
            packed_j = torch.where(
                lane_r == j, beta, torch.where(lane_r > j, x * scale, x)
            )
            at[..., s : s + ibk, :wl] = torch.where(
                sub_b == jj,
                packed_j[..., None, :],
                blk - torch.where(sub_b > jj, tau[..., None] * w, zero) * v[..., None, :],
            )
            tt[..., j, :] = torch.where(lane_t == j, tau, zero)

        vt_b = _recon_vt(at[..., s : s + ibk, :wl], s, lane_r)  # (..., ibk, wl) = V_bᵀ

        # block T by doubling, computed transposed (ttb = T_bᵀ)
        g = vt_b @ _t(vt_b)
        taus = torch.diagonal(tt[..., s : s + ibk, s : s + ibk], dim1=-2, dim2=-1)[..., None]
        rows_b = torch.arange(ibk, device=dev)[:, None]
        cols_b = torch.arange(ibk, device=dev)[None, :]
        ttb = torch.where(rows_b == cols_b, taus, zero)
        bsz = 1
        while bsz < ibk:
            mask = ((cols_b // bsz) % 2 == 0) & (rows_b // bsz == cols_b // bsz + 1)
            gm = torch.where(mask, g, zero)
            ttb = ttb - ttb @ (gm @ ttb)
            bsz *= 2
        tt[..., s : s + ibk, s : s + ibk] = ttb

        # A_rest ← A_rest − V_b T_bᵀ V_bᵀ A_rest
        if s + ibk < n:
            at_rest = at[..., s + ibk :, :wl]
            w1 = at_rest @ _t(vt_b)
            w2 = w1 @ _t(ttb)
            at[..., s + ibk :, :wl] = at_rest - w2 @ vt_b

        # off-diagonal T[0:s, block] = −T1 (V1ᵀ V_b) T_b, stored transposed
        if s > 0:
            vt_prev = _recon_vt(at[..., 0:s, :wl], 0, lane_r)
            zt = vt_b @ _t(vt_prev)
            m2 = zt @ tt[..., 0:s, 0:s]
            tt[..., s : s + ibk, 0:s] = -(ttb @ m2)


def _check_stack(a: torch.Tensor, ib: int) -> None:
    if a.dim() != 3 or 0 in a.shape:
        raise ValueError(f"geqrt_batched expects a (B, m, n) stack, got {tuple(a.shape)}")
    if ib < 1:
        raise ValueError(f"ib={ib} must be >= 1")


def geqrt_batched_plain(a: torch.Tensor, ib: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch batched GEQRT: the JAX kernels' column loop on the whole
    stack at once (no loop over B). Returns (packed (B, m, n), T (B, n, n))."""
    _build.PLAIN_CALLS["geqrt_batched"] += 1
    _check_stack(a, ib)
    b, m, n = a.shape
    at = _t(a).clone(memory_format=torch.contiguous_format)
    tt = a.new_zeros((b, n, n))
    geqrt_in_place(at, tt, min(m, n), ib)
    return _t(at).contiguous(), _t(tt).contiguous()


def t_from_gram(g: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """T (..., k, k) of a block of k reflectors from their gram G = VᵀV
    (..., k, k; only its strict upper triangle is read) and their taus
    (..., k), by LAPACK's column recurrence (larft):
    T[0:j, j] = −τ_j · T[0:j, 0:j] · G[0:j, j], T[j, j] = τ_j. In exact
    arithmetic T is unique given V and τ, so this is the T that
    ``geqrt_in_place`` builds by doubling; the small route
    (``csrc/geqrt_small.cu``) builds each block's T this way."""
    k = tau.shape[-1]
    t = torch.zeros(g.shape, dtype=g.dtype, device=g.device)
    for j in range(k):
        t[..., j, j] = tau[..., j]
        if j:
            t[..., :j, j] = -tau[..., j, None] * (t[..., :j, :j] @ g[..., :j, j, None])[..., 0]
    return t


# ---- the thread-block cluster routine (csrc/geqrt_cluster.cuh) ----

# the cluster kernel's constants: threads per CTA, the chunk width of its
# block products, its GEMM staging tile and depth
CL_THREADS, CL_CW, CL_GI, CL_GJ, CL_GK = 512, 64, 128, 64, 16
# floats of the column exchange's words after the buffers: two mbarriers
# (8 bytes each), the count of columns exchanged (4 bytes), padding
CL_XCH_FLOATS = 6
# couple rows per CTA the plan aims at: K1's 512 rows on 8 CTAs, K2's
# 1280 on 16 (the nb = 512 chain's 2560 on 16 as well, 160 rows a CTA);
# on the H100 80 rows a CTA ran K1 and K2 faster than 160 (PERF.md)
ROWS_PER_CTA = 80


class ClusterPlan(NamedTuple):
    ctas: int          # C, the CTAs of the one cluster
    smem_bytes: int    # dynamic shared memory per CTA
    resident: bool     # the active block, Tb and the work buffer in shared memory
    rows_per_cta: int  # ceil(rows / C): CTA q owns couple rows [q·rpc, (q+1)·rpc)


def cluster_exchange_offset(nb: int, rows: int, ib: int, ctas: int, resident: bool) -> int:
    """Byte offset of the column exchange's words in a CTA's shared memory
    (``geqrt_cluster.cuh``: ``xch_offset``), after its buffers at an even
    float, so 8-byte aligned: GEMM staging, column partials (two parities
    of (C + 1)·ib: every CTA's dots and row j), group partials, taus and two
    scalars; when resident also the slab
    (max(rpc, ib) × (ib+1): it holds G while Tb is built), Tb (ib × (ib+1))
    and the work buffer."""
    rpc = -(-rows // ctas)
    pow2 = 1
    while 2 * pow2 < ib:
        pow2 *= 2
    ycols = max(CL_CW, pow2, -(-nb // ctas))
    small = CL_GK * (CL_GI + CL_GJ) + 2 * (ctas + 1) * ib + max(ib, CL_THREADS) + ib + 2
    big = max(rpc, ib) * (ib + 1) + ib * (ib + 1) + ib * ycols
    floats = small + (big if resident else 0)
    return 4 * (floats + floats % 2)


def cluster_smem_bytes(nb: int, rows: int, ib: int, ctas: int, resident: bool) -> int:
    """Shared bytes per CTA of a cluster launch (``geqrt_cluster.cuh``:
    ``sizes``/``smem_floats``): the buffers, then the column exchange's
    words (``CL_XCH_FLOATS``: an mbarrier per parity buffer of the
    partials, the count of columns exchanged, padding)."""
    return cluster_exchange_offset(nb, rows, ib, ctas, resident) + 4 * CL_XCH_FLOATS


def cluster_plan_at(nb: int, rows: int, ib: int, ctas: int) -> ClusterPlan:
    """The cluster routine's plan on C = ``ctas`` CTAs for couples of
    ``rows`` rows: the active block in their shared memory where it fits,
    else in a global workspace."""
    if nb < 1 or ib < 1 or rows < nb or ctas not in _build.CLUSTER_SIZES:
        raise ValueError(f"cluster_plan_at: nb={nb}, rows={rows}, ib={ib}, ctas={ctas}")
    resident = cluster_smem_bytes(nb, rows, ib, ctas, True) <= _build.SMEM_LIMIT
    return ClusterPlan(ctas, cluster_smem_bytes(nb, rows, ib, ctas, resident), resident,
                       -(-rows // ctas))


def cluster_plan(nb: int, rows: int, ib: int, rows_per_cta: Optional[int] = None) -> ClusterPlan:
    """The cluster of a K1/K2 launch whose largest couple has ``rows`` rows
    (K1: 2·nb, or nb with no couples; K2: nb + block_rows): the fewest CTAs
    that hold at most ``rows_per_cta`` rows each (ROWS_PER_CTA by default,
    16 CTAs at most), grown while the active block does not fit one CTA's
    shared memory; where it fits at no size, the smallest such cluster with
    the block in a global workspace."""
    if nb < 1 or ib < 1 or rows < nb:
        raise ValueError(f"cluster_plan: nb={nb}, rows={rows}, ib={ib}")
    sizes = _build.CLUSTER_SIZES
    target = ROWS_PER_CTA if rows_per_cta is None else rows_per_cta
    fits = [c for c in sizes if -(-rows // c) <= target]
    c0 = fits[0] if fits else sizes[-1]
    for c in sizes[sizes.index(c0):]:
        plan = cluster_plan_at(nb, rows, ib, c)
        if plan.resident:
            return plan
    return cluster_plan_at(nb, rows, ib, c0)


# ---- the batched GEQRT's cluster route ----

# the cluster routine's index math (``geqrt_cluster.cuh``: div_small) takes
# a CTA's slab entries, rows per CTA × ib, below this
_CLUSTER_INDEX_MAX = 2 ** 20
# rows a CTA the cluster route aims at: a 256² tile on 8 CTAs took 0.95-0.97
# ms on the H100 against 1.04-1.06 on 4 (K1/K2's 80 rows) and 0.98-1.00 on
# 16 (utils/plan_sweep.py, PERF.md); taller matrices reach 16 CTAs either way
BATCHED_ROWS_PER_CTA = 32


class BatchedClusterPlan(NamedTuple):
    ctas: int          # C, the CTAs of each matrix's cluster; 1: the one-block kernel
    ib: int            # the block width the cluster runs, min(ib, n)
    smem_bytes: int    # dynamic shared memory per CTA (0 when ctas = 1)
    resident: bool     # a CTA's rows of the active block in its shared memory


def batched_cluster_plan_at(m: int, n: int, ib: int, ctas: int) -> BatchedClusterPlan:
    """The plan of an (m, n) stack at inner width ``ib`` on C = ``ctas``
    CTAs a matrix: at C = 1 the one-block kernel, else the cluster route
    at block width min(ib, n), its block in the CTAs' shared memory where
    it fits (m ≥ n)."""
    if m < 1 or n < 1 or ib < 1 or ctas not in _build.CLUSTER_SIZES or (ctas > 1 and m < n):
        raise ValueError(f"batched_cluster_plan_at: m={m}, n={n}, ib={ib}, ctas={ctas}")
    if ctas == 1:
        return BatchedClusterPlan(1, ib, 0, False)
    p = cluster_plan_at(n, m, min(ib, n), ctas)
    return BatchedClusterPlan(ctas, min(ib, n), p.smem_bytes, p.resident)


def batched_cluster_plan(b: int, m: int, n: int, ib: int, sms: int) -> BatchedClusterPlan:
    """The route of a (b, m, n) stack at inner width ``ib`` on a card of
    ``sms`` SMs: C = ``cluster_plan``'s for a matrix as one couple of m
    rows at ``BATCHED_ROWS_PER_CTA`` rows a CTA, halved to the largest
    power of two with b·C ≤ sms, and its block in the CTAs' shared memory
    where it fits. C = 1 (the one-block kernel) when m < n, when C falls
    to 1, or when a CTA's rows × ib reach the cluster routine's index
    limit."""
    if b < 1 or m < 1 or n < 1 or ib < 1 or sms < 1:
        raise ValueError(f"batched_cluster_plan: b={b}, m={m}, n={n}, ib={ib}, sms={sms}")
    c = 1
    if m >= n:
        c = cluster_plan(n, m, min(ib, n), BATCHED_ROWS_PER_CTA).ctas
        while c > 1 and b * c > sms:
            c //= 2
        if -(-m // c) * min(ib, n) >= _CLUSTER_INDEX_MAX:
            c = 1
    return batched_cluster_plan_at(m, n, ib, c)


def small_tile_ld(m: int) -> int:
    """The small route's tile row stride (``csrc/geqrt_small.cu``:
    ``tile_ld``): a multiple of 4 floats ≥ max(m, 128) whose quarter is
    odd."""
    return 4 * ((-(-max(m, 128) // 4)) | 1)


# T is built a sub-block of this many columns at a time (csrc/geqrt_small.cu:
# TB), each from its own G = V_qᵀV_q (its strict upper triangle kept)
SMALL_T_SUB = 32


def small_smem_bytes(m: int, n: int, ib: int) -> int:
    """Shared bytes of a small-route CTA (``csrc/geqrt_small.cu``:
    ``smem_floats``): the transposed tile (n rows of ``small_tile_ld(m)``
    floats), T packed as its upper triangle (kc(kc + 1)/2, kc = min(m, n)),
    each T sub-block's G (its strict upper triangle, 32·31/2 floats, for
    each of the ceil(min(ib, kc)/32) sub-blocks of a block) and two LARFG
    triples (beta, tau, scale)."""
    kc = min(m, n)
    g = -(-min(ib, kc) // SMALL_T_SUB) * (SMALL_T_SUB * (SMALL_T_SUB - 1) // 2)
    return 4 * (n * small_tile_ld(m) + kc * (kc + 1) // 2 + g + 6)


def small_threads(m: int, n: int, ib: int) -> int:
    """Threads of a small-route CTA: 512 where the matrix is one block (m ≥ n,
    ib ≥ n: no block apply, so two CTAs an SM fit in registers), else 256."""
    return 512 if m >= n and ib >= n else SMALL_THREADS


def takes_small(m: int, n: int) -> bool:
    """Whether an (m, n) matrix takes the small route."""
    return 4 * (m * n + n * n + m) <= _SMALL_MAX_BYTES


# ---- the tall route (csrc/geqrt_tall.cu) ----

# the panel widths the tall route is built for, widest first
TALL_WIDTHS = (16, 8)
# rows a partial sum of the route's contractions over rows runs (its f32_tile
# KC, as csrc/geqrt.cuh's GEMM_KCHUNK)
TALL_KCHUNK = 256
# bytes of f32_tile's cp.async ring at 128 x 128 (tile_gemm.cuh: f32_smem,
# the larger of its two A layouts), which shares the panel's shared memory
_TALL_RING_BYTES = 4 * 3 * (128 * 20 + 16 * 128)
# the kinds of tall_schedule's operations (csrc/geqrt_tall.cu: OP_*)
OP_PANEL, OP_UPDATE, OP_TRAIL, OP_JOIN, OP_JOIN_BLOCK = range(5)


def tall_smem_bytes(m: int, w: int) -> int:
    """Shared bytes of a tall-route CTA at panel width ``w``
    (``csrc/geqrt_tall.cu``: ``smem_bytes``): the panel (m × w), the
    warps' partials (2 × 8 × w), two posted head rows, G and the panel's T
    (w² each) and its taus; at least the products' cp.async ring, which
    reuses the same bytes."""
    return max(4 * (m * w + 2 * (TALL_THREADS // 32) * w + 2 * w + 2 * w * w + w),
               _TALL_RING_BYTES)


class TallPlan(NamedTuple):
    w: int             # the panel width, 8 or 16
    ctas: int          # CTAs a matrix: 1
    threads: int       # threads a CTA
    smem_bytes: int    # dynamic shared memory per CTA
    grid: int          # persistent CTAs, one an SM: min(b, sms)
    ib: int            # the block width


def tall_plan_at(b: int, m: int, n: int, ib: int, sms: int, w: int) -> Optional[TallPlan]:
    """The tall route's plan for a (b, m, n) stack, m ≥ n, at panel width
    ``w`` on a card of ``sms`` SMs (a grid of min(b, sms) persistent CTAs),
    or None where a panel of w columns is past one CTA's shared memory."""
    if b < 1 or m < n or n < 1 or ib < 1 or sms < 1 or w not in TALL_WIDTHS:
        raise ValueError(f"tall_plan_at: b={b}, m={m}, n={n}, ib={ib}, sms={sms}, w={w}")
    smem = tall_smem_bytes(m, w)
    if smem > _build.SMEM_LIMIT:
        return None
    return TallPlan(w, 1, TALL_THREADS, smem, min(b, sms), ib)


def tall_plan(b: int, m: int, n: int, ib: int, sms: int) -> Optional[TallPlan]:
    """The tall route's plan for a (b, m, n) stack at inner width ``ib`` on
    a card of ``sms`` SMs, or None where the route does not take it (m < n,
    or a panel of 8 columns past one CTA's shared memory: n = 8 leaves of
    131072 rows). w: the widest of ``TALL_WIDTHS`` whose panel fits one
    CTA and that is no wider than the block (min(ib, n), at least 8); a
    grid of min(b, sms) persistent CTAs, one an SM. On the H100 w = 16
    took 64.5 ms on the 512 tsqr leaves (2048 × 512) and 16.1 on the 128
    stacks of level 1, against 85.0 and 21.3 for w = 8 (and 76.0 and 26.9
    for w = 8 at two leaves an SM on 64 × 64 product tiles); on 4096
    stacks of 256² 47.8 ms, against 52.6 for w = 8 and 112.1 for the
    one-block kernel (``utils/plan_sweep.py --only tall``)."""
    if b < 1 or m < 1 or n < 1 or ib < 1 or sms < 1:
        raise ValueError(f"tall_plan: b={b}, m={m}, n={n}, ib={ib}, sms={sms}")
    if m < n:
        return None
    cap = max(8, min(ib, n))
    plans = (tall_plan_at(b, m, n, ib, sms, w) for w in TALL_WIDTHS if w <= cap)
    return next((p for p in plans if p is not None), None)


def tall_schedule(n: int, ib: int, w: int) -> List[Tuple[int, int, int, int]]:
    """The tall route's operations on an (m, n) matrix, m ≥ n, in order, as
    (kind, c0, h1, h2) (``csrc/geqrt_tall.cu`` runs them on every matrix
    of the stack): each ib-column block [s, e) factored recursively, its
    columns split at a panel boundary into halves (the left half factored,
    then ``OP_UPDATE`` of the right half by it, the right half factored,
    ``OP_JOIN`` of the two), down to ``OP_PANEL``s of w columns (the last
    one narrower); then ``OP_TRAIL``, the columns [e, n) updated by the
    block, and ``OP_JOIN_BLOCK``, the block's T against the columns [0, s).
    An update takes the reflectors [c0, c0 + h1) to the columns [c0 + h1,
    c0 + h1 + h2); a join sets T[c0 : c0 + h1, c0 + h1 : c0 + h1 + h2]."""
    if n < 1 or ib < 1 or w < 1:
        raise ValueError(f"tall_schedule: n={n}, ib={ib}, w={w}")
    ops: List[Tuple[int, int, int, int]] = []

    def rec(a: int, b: int) -> None:
        if b - a <= w:
            ops.append((OP_PANEL, a, b - a, 0))
            return
        mid = a + (-(-(b - a) // w) // 2) * w
        rec(a, mid)
        ops.append((OP_UPDATE, a, mid - a, b - mid))
        rec(mid, b)
        ops.append((OP_JOIN, a, mid - a, b - mid))

    for s in range(0, n, ib):
        e = min(s + ib, n)
        rec(s, e)
        if e < n:
            ops.append((OP_TRAIL, s, e - s, n - e))
        if s > 0:
            ops.append((OP_JOIN_BLOCK, 0, s, e - s))
    return ops


class BatchedPlan(NamedTuple):
    route: str         # "small", "cluster", "tall" or "global" (the one-block kernel)
    ctas: int          # the cluster route's C; 1 on the others
    ib: int            # the block width the kernel runs
    smem_bytes: int    # dynamic shared memory per CTA (0 on the global route)
    resident: bool     # cluster route: a CTA's rows of the active block in shared memory
    threads: int       # threads a CTA


def batched_plan(b: int, m: int, n: int, ib: int, sms: int) -> BatchedPlan:
    """The route of a (b, m, n) stack at inner width ``ib`` on a card of
    ``sms`` SMs: the small route where the matrix takes it (m < n
    included; on the H100 it beat the cluster route at 5 of the 6 stacks
    both take that ``utils/plan_sweep.py --only small`` times, losing 10% at
    8 × 256×64, a shape no path runs), else ``batched_cluster_plan``'s
    cluster where C > 1 (the tsqr tree's levels of ≤ 32 stacks, B1s), else
    the tall route where ``tall_plan`` takes the stack (the tsqr leaves
    and the tree's level of 128 stacks, qr_batched's 4096 × 256²), else
    the one-block kernel on its tile in global memory: a stack of m < n
    past the small route, or tall matrices whose 8-column panel is past
    shared memory (n = 8 leaves of 131072 rows, in stacks too large for
    the cluster route)."""
    if b < 1 or m < 1 or n < 1 or ib < 1 or sms < 1:
        raise ValueError(f"batched_plan: b={b}, m={m}, n={n}, ib={ib}, sms={sms}")
    if takes_small(m, n):
        return BatchedPlan("small", 1, ib, small_smem_bytes(m, n, ib), True,
                           small_threads(m, n, ib))
    cl = batched_cluster_plan(b, m, n, ib, sms)
    if cl.ctas > 1:
        return BatchedPlan("cluster", cl.ctas, cl.ib, cl.smem_bytes, cl.resident, CL_THREADS)
    tall = tall_plan(b, m, n, ib, sms)
    if tall is not None:
        return BatchedPlan("tall", 1, ib, tall.smem_bytes, True, tall.threads)
    return BatchedPlan("global", 1, ib, 0, False, GLOBAL_THREADS)


def _geqrt_small(a: torch.Tensor, ib: int, threads: int = 0) -> Tuple[torch.Tensor, ...]:
    """The small route on a contiguous CUDA stack at ``threads`` a CTA
    (default: ``small_threads``): (packed, T)."""
    b, m, n = a.shape
    threads = threads or small_threads(m, n, ib)
    packed = torch.empty_like(a)
    t = a.new_empty((b, n, n))
    rc = _build.lib().tq_geqrt_small(a.data_ptr(), packed.data_ptr(), t.data_ptr(), b, m, n, ib,
                                     threads, small_smem_bytes(m, n, ib), _build.stream())
    _build.check(rc, "geqrt_batched[small]")
    _build.LAUNCHES["geqrt_batched[small]"] += 1
    return packed, t


def _geqrt_one_block(a: torch.Tensor, ib: int) -> Tuple[torch.Tensor, ...]:
    """The one-block kernel on a contiguous CUDA stack: (packed, T)."""
    b, m, n = a.shape
    lib = _build.lib()
    grid = lib.tq_geqrt_batched_grid(b, m)
    if grid <= 0:
        _build.check(-grid, "geqrt_batched")
    packed = torch.empty_like(a)
    t = a.new_empty((b, n, n))
    work = a.new_empty(grid * lib.tq_geqrt_batched_work_floats(m, n, ib))
    rc = lib.tq_geqrt_batched(a.data_ptr(), packed.data_ptr(), t.data_ptr(), work.data_ptr(),
                              b, m, n, min(m, n), ib, grid, _build.stream())
    _build.check(rc, "geqrt_batched")
    _build.LAUNCHES["geqrt_batched"] += 1
    return packed, t


@functools.lru_cache(maxsize=None)
def _tall_ops(n: int, ib: int, w: int, device: torch.device) -> torch.Tensor:
    """``tall_schedule(n, ib, w)`` as an int32 tensor on ``device``, built
    and copied there once a shape (the copy blocks the host)."""
    with span("tileqr_torch.sync.tall_ops"):
        return torch.tensor(tall_schedule(n, ib, w), dtype=torch.int32, device=device)


def _geqrt_tall(a: torch.Tensor, plan: TallPlan) -> Tuple[torch.Tensor, ...]:
    """The tall route on a contiguous CUDA stack (b, m, n), m ≥ n, at
    ``plan`` (``tall_plan``'s, or any width the kernel is built for):
    (packed, T)."""
    b, m, n = a.shape
    if m < n or plan.w not in TALL_WIDTHS or plan.grid < 1:
        raise ValueError(f"geqrt_batched[tall]: {tuple(a.shape)} at {plan}")
    ibm = min(plan.ib, n)
    ops = _tall_ops(n, plan.ib, plan.w, a.device)
    vec = all(x % 4 == 0 for x in (m, n, ibm, plan.w))
    packed = torch.empty_like(a)
    t = a.new_empty((b, n, n))
    work = a.new_empty(plan.grid * 2 * ibm * n)
    rc = _build.lib().tq_geqrt_tall(a.data_ptr(), packed.data_ptr(), t.data_ptr(),
                                    work.data_ptr(), ops.data_ptr(), ops.shape[0], b, m, n, ibm,
                                    plan.w, int(vec), plan.grid, plan.smem_bytes,
                                    _build.stream())
    _build.check(rc, "geqrt_batched[tall]")
    _build.LAUNCHES["geqrt_batched[tall]"] += 1
    return packed, t


def _geqrt_cluster(a: torch.Tensor, plan) -> Tuple[torch.Tensor, ...]:
    """The cluster route on a contiguous CUDA stack at ``plan`` (a
    ``BatchedClusterPlan`` or the cluster route's ``BatchedPlan``): (packed,
    T)."""
    b, m, n = a.shape
    lib = _build.lib()
    packed = torch.empty_like(a)
    t = a.new_empty((b, n, n))
    work = a.new_empty(b * lib.tq_cluster_work_floats(n, m, plan.ib, plan.ctas,
                                                      int(plan.resident)))
    rc = lib.tq_geqrt_batched_cluster(a.data_ptr(), packed.data_ptr(), t.data_ptr(),
                                      work.data_ptr(), b, m, n, plan.ib, plan.ctas,
                                      plan.smem_bytes, int(plan.resident), _build.stream())
    _build.check(rc, "geqrt_batched[cluster]")
    _build.count_exchange(plan.ctas, b * n)  # a cluster a matrix, n = min(m, n) columns
    _build.LAUNCHES["geqrt_batched[cluster]"] += 1
    return packed, t


def geqrt_batched(a: torch.Tensor, ib: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GEQRT of every matrix of a (B, m, n) with inner block width ``ib``,
    kcols = min(m, n). Returns (packed (B, m, n): R on and above the
    diagonal, the reflectors below; T (B, n, n)). ``a`` is not written."""
    if not _build.is_cuda(a):
        return geqrt_batched_plain(a, ib)
    _build.require_fp32(a)
    _check_stack(a, ib)
    a = a.contiguous()
    b, m, n = a.shape
    if m * n >= 2 ** 30:
        raise ValueError(f"geqrt_batched: a {m}x{n} matrix is past the kernel's int offsets")
    plan = batched_plan(b, m, n, ib, _build.sm_count(a))
    if plan.route == "small":
        return _geqrt_small(a, ib)
    if plan.route == "cluster":
        return _geqrt_cluster(a, plan)
    if plan.route == "tall":
        return _geqrt_tall(a, tall_plan(b, m, n, ib, _build.sm_count(a)))
    return _geqrt_one_block(a, ib)


def geqrt(a: torch.Tensor, ib: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-tile GEQRT: a (m, n) → (packed (m, n), T (n, n)); the B = 1
    case of ``geqrt_batched`` (``tileqr.kernels.geqrt.geqrt``)."""
    if a.dim() != 2:
        raise ValueError(f"geqrt expects a 2-D tile, got {tuple(a.shape)}")
    packed, t = geqrt_batched(a[None], ib)
    return packed[0], t[0]

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
``geqrt_in_place`` on the CPU.

This module also holds the batched GEQRT (``geqrt_batched``), the port of
four TPU kernels that compute the same function, GEQRT of every matrix of
a stack with inner block width ``ib`` (packed reflectors and T):
``tileqr/drivers/batched.py:geqrt_batched`` (one matrix per grid step),
``batched.py:geqrt_batched_grouped`` (G matrices per grid step),
``tileqr/drivers/tsqr.py:tall_geqrt`` (every leaf of a tall matrix, and the
tree's stacked R factors) and ``tileqr/kernels/geqrt.py:geqrt`` (B = 1).
On a CUDA tensor it launches ``tq_geqrt_batched``
(``csrc/geqrt_batched.cu``); on a CPU tensor it runs
``geqrt_batched_plain``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels import _build

# a tile whose transposed copy, Tᵀ and reflector (4·(m·n + n·n + m) bytes)
# fit this is factored in shared memory; larger ones in a global workspace
_RESIDENT_MAX_BYTES = 200 * 1024


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
    ``lane_extent``): every step of that block runs on those rows only, as
    ``csrc/geqrt.cuh`` does. Default: all m rows.
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
    resident = int(4 * (m * n + n * n + m) <= _RESIDENT_MAX_BYTES)
    lib = _build.lib()
    grid = lib.tq_geqrt_batched_grid(b, m, n, resident)
    if grid <= 0:
        _build.check(-grid, "geqrt_batched")
    packed = torch.empty_like(a)
    t = a.new_empty((b, n, n))
    work = a.new_empty(grid * lib.tq_geqrt_batched_work_floats(m, n, ib, resident))
    rc = lib.tq_geqrt_batched(a.data_ptr(), packed.data_ptr(), t.data_ptr(), work.data_ptr(),
                              b, m, n, min(m, n), ib, resident, grid, _build.stream())
    _build.check(rc, "geqrt_batched")
    _build.LAUNCHES["geqrt_batched"] += 1
    return packed, t


def geqrt(a: torch.Tensor, ib: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-tile GEQRT: a (m, n) → (packed (m, n), T (n, n)); the B = 1
    case of ``geqrt_batched`` (``tileqr.kernels.geqrt.geqrt``)."""
    if a.dim() != 2:
        raise ValueError(f"geqrt expects a 2-D tile, got {tuple(a.shape)}")
    packed, t = geqrt_batched(a[None], ib)
    return packed[0], t[0]

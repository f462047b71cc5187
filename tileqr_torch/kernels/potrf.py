"""Batched upper Cholesky (B9): G (B, n, n) SPD → R upper with RᵀR = G.

Counterpart of ``tileqr/drivers/cholqr.py:potrf_batched``
(``_mk_potrf_kernel``): rows are factored in panels of ``bp`` rows; inside
a panel each row step scales row j by the clamped pivot rsqrt(max(d2,
1e-30)) and rank-1-updates the panel rows below it on the lanes right of
j (the TRSM folded in); after the panel, one SYRK updates the trailing
matrix. The clamp makes a breakdown show up as NaN or a huge value in the
hr health scalar instead of an exception. Zeros are written left of the
diagonal.

On a CUDA tensor the wrapper launches ``tq_potrf_batched``
(``csrc/potrf.cu``: a blocked Cholesky on one thread-block cluster a
matrix, its bp-row blocks dealt cyclically to the CTAs' shared memory,
sized by ``potrf_plan``); on a CPU tensor it runs the plain version, which
keeps the JAX kernel's bp-row panels and its symmetric trailing update, so
float64 parity is at rounding level. The reference's ``group`` (matrices
per TPU grid step) has no counterpart: the CUDA grid is the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tileqr_torch.kernels import _build

# rows a CTA the plan aims at: C = 4 at n = 256 (the hr panel's gram), 8 at
# 512 (the tsqr cholqr2 factor's)
POTRF_ROWS_PER_CTA = 64
# the kernel's largest panel (csrc/potrf.cu: BP, its rows in registers), and
# its widest matrix (8 columns a thread of 512 in a row step)
POTRF_BP_MAX = 16
POTRF_N_MAX = 4096


class PotrfPlan(NamedTuple):
    ctas: int          # C, the CTAs of each matrix's cluster; block k on CTA k mod C
    smem_bytes: int    # dynamic shared memory per CTA
    resident: bool     # the blocks in shared memory (else in the output, L2)
    threads: int       # threads a CTA (potrf_threads)


def _round4(x: int) -> int:
    return (x + 3) & ~3


def potrf_smem_bytes(n: int, ctas: int, resident: bool, bp: int = 16) -> int:
    """Shared bytes per CTA of a B9 launch (``csrc/potrf.cu``:
    ``smem_floats``): a panel's pivot columns and reciprocal roots (16 × 16
    + 16 floats), and when resident CTA 0's blocks (blocks 0, C, 2C, …: bp rows each,
    from the block's first column on, row stride rounded up to 4) and, on
    a cluster (C > 1), the copy of a panel (bp × round4(n))."""
    bp = min(bp, n)
    piv = POTRF_BP_MAX * POTRF_BP_MAX + POTRF_BP_MAX
    if not resident:
        return 4 * piv
    nblk = -(-n // bp)
    own = sum(bp * _round4(n - k * bp) for k in range(0, nblk, ctas))
    copy = bp * _round4(n) if ctas > 1 else 0
    return 4 * (piv + own + copy)


def potrf_threads(n: int) -> int:
    """Threads of a B9 CTA: the fewest of 128, 256 and 512 that hold a
    panel row at two columns a thread (a row step's work) where n allows;
    512 past 1024 columns (the global route, up to 8 a thread)."""
    return 128 if n <= 128 else 256 if n <= 512 else 512


def potrf_plan_at(b: int, n: int, ctas: int, bp: int = 16) -> PotrfPlan:
    """B9's plan on C = ``ctas`` CTAs a matrix: its blocks in their shared
    memory where they fit, else in the output."""
    if b < 1 or n < 1 or bp < 1 or ctas not in _build.CLUSTER_SIZES:
        raise ValueError(f"potrf_plan_at: b={b}, n={n}, ctas={ctas}, bp={bp}")
    resident = potrf_smem_bytes(n, ctas, True, bp) <= _build.SMEM_LIMIT
    return PotrfPlan(ctas, potrf_smem_bytes(n, ctas, resident, bp), resident, potrf_threads(n))


def potrf_plan(b: int, n: int, sms: int, bp: int = 16) -> PotrfPlan:
    """The cluster of a B9 launch on a (b, n, n) stack on a card of ``sms``
    SMs: the fewest CTAs (16 at most) that hold at most POTRF_ROWS_PER_CTA
    rows each, halved while b·C exceeds the SMs (C = 1: a matrix a CTA,
    several CTAs an SM); the blocks in the CTAs' shared memory where they
    fit, else the same code on the output in global memory."""
    if b < 1 or n < 1 or sms < 1 or bp < 1:
        raise ValueError(f"potrf_plan: b={b}, n={n}, sms={sms}, bp={bp}")
    fits = [c for c in _build.CLUSTER_SIZES if -(-n // c) <= POTRF_ROWS_PER_CTA]
    c = fits[0] if fits else _build.CLUSTER_SIZES[-1]
    while c > 1 and b * c > sms:
        c //= 2
    return potrf_plan_at(b, n, c, bp)


def _check(g: torch.Tensor, bp: int) -> None:
    if g.dim() != 3 or g.shape[1] != g.shape[2]:
        raise ValueError(f"potrf_batched expects (B, n, n), got {tuple(g.shape)}")
    if bp < 1:
        raise ValueError(f"bp={bp} must be >= 1")


def potrf_batched_plain(g: torch.Tensor, bp: int = 16) -> torch.Tensor:
    """Plain torch B9, the JAX kernel's steps on the whole batch."""
    _build.PLAIN_CALLS["potrf_batched"] += 1
    _check(g, bp)
    n = g.shape[1]
    r = g.clone()
    lane = torch.arange(n, device=g.device)
    for s in range(0, n, bp):
        e = min(s + bp, n)
        for j in range(s, e):
            rowv = r[:, j : j + 1, :]  # (B, 1, n)
            colv = r[:, j + 1 : e, j : j + 1]  # panel rows below j, lane j
            rinv = torch.rsqrt(torch.clamp(rowv[:, :, j : j + 1], min=1e-30))
            row_scaled = rowv * rinv
            upd = (colv * rinv) * row_scaled[:, :, j + 1 :]
            r[:, j + 1 : e, j + 1 :] = r[:, j + 1 : e, j + 1 :] - upd
            r[:, j, :] = torch.where(lane >= j, row_scaled[:, 0], 0.0)
        if e < n:
            r12 = r[:, s:e, e:]
            r[:, e:, e:] -= r12.transpose(1, 2) @ r12
    return r


def potrf_batched(g: torch.Tensor, bp: int = 16) -> torch.Tensor:
    """Batched upper Cholesky of g (B, n, n) SPD. Returns R (B, n, n)."""
    if not _build.is_cuda(g):
        return potrf_batched_plain(g, bp)
    _build.require_fp32(g)
    _check(g, bp)
    b, n, _ = g.shape
    bpe = min(bp, n)
    if bpe > POTRF_BP_MAX or (bpe < n and bpe % 4):
        raise ValueError(f"potrf_batched: the kernel takes bp <= {POTRF_BP_MAX}, a multiple of "
                         f"4 unless it covers n; got bp={bp} at n={n}")
    if n > POTRF_N_MAX:
        raise ValueError(f"potrf_batched: n={n} is past the kernel's {POTRF_N_MAX} columns")
    plan = potrf_plan(b, n, _build.sm_count(g), bp)
    r = _launch_potrf(g.contiguous(), bp, plan)
    _build.LAUNCHES["potrf_batched"] += 1
    return r


def _launch_potrf(g: torch.Tensor, bp: int, plan: PotrfPlan) -> torch.Tensor:
    """One B9 launch on a contiguous CUDA stack (b, n, n) in panels of
    ``bp`` rows at ``plan`` (``potrf_plan``'s, or ``potrf_plan_at``'s at
    any C): R."""
    b, n, _ = g.shape
    r = torch.empty_like(g)
    rc = _build.lib().tq_potrf_batched(g.data_ptr(), r.data_ptr(), b, n, bp, plan.ctas,
                                       plan.threads, plan.smem_bytes, int(plan.resident),
                                       _build.stream())
    _build.check(rc, "potrf_batched")
    return r

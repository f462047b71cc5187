"""Batched CholeskyQR2 and the CholeskyQR helpers of the hr panel.

Counterparts of ``tileqr/drivers/cholqr.py``: ``cholqr2_batched``, the
pairwise tall contraction ``bdot_pair_rows``, the breakdown guard
``guard_falls_back``, the matmul-only triangular inverse (``_diag_of``,
``_inv_factors``, ``_apply_rinv``, ``_triu_inv_doubling``), ``_up_half``
the matmul-only second round (``_correction``) and the health
(``_defect``). The POTRF kernel
itself (B9) is ``tileqr_torch/kernels/potrf.py``. Products accumulate in
the operand dtype (float32 on the card, never TF32: ``_highest``, the
port's ``Precision.HIGHEST``, which every driver's products run under;
float64 on the CPU), as ``acc_type`` does in the reference.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from tileqr_torch.core.trace import count_guard, span
from tileqr_torch.kernels.common import refuse_xla_site
from tileqr_torch.kernels.potrf import potrf_batched

# quadratic iterations of the second CholeskyQR round (the reference's default)
_CORRECTION_ITERS = 2


@contextlib.contextmanager
def _highest():
    """IEEE fp32 matmuls (no TF32) inside, the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def bdot_pair_rows(x: torch.Tensor, y: torch.Tensor, blk: int = 512,
                   cap_bytes: int = 1 << 28) -> torch.Tensor:
    """xᵀ·y contracting the ROW dim of (B, m, p) × (B, m, q) → (B, p, q)
    with pairwise (binary-tree) block accumulation: block partials from one
    batched matmul, tree-summed. A single contraction accumulates the m
    terms in sequence (error ~ √m·eps); the tree's is ~ √(blk + log m)·eps.
    nblk is capped so the partials stay under ``cap_bytes``."""
    b, m, p = x.shape
    q = y.shape[2]
    itemsize = x.element_size()
    nblk = min(m // blk, max(1, cap_bytes // max(1, b * p * q * itemsize)))
    if nblk < 2:
        return x.transpose(1, 2) @ y
    be = (m // nblk) // 8 * 8
    body = nblk * be
    px = x[:, :body].reshape(b, nblk, be, p)
    py = y[:, :body].reshape(b, nblk, be, q)
    parts = px.transpose(2, 3) @ py  # (B, nblk, p, q)
    if body < m:
        tail = x[:, body:].transpose(1, 2) @ y[:, body:]
        parts = torch.cat([parts, tail[:, None]], dim=1)
    while parts.shape[1] > 1:
        n2 = parts.shape[1] // 2
        s = parts[:, 0 : 2 * n2 : 2] + parts[:, 1 : 2 * n2 : 2]
        if parts.shape[1] % 2:
            s = torch.cat([s, parts[:, 2 * n2 :]], dim=1)
        parts = s
    return parts[:, 0]


def guard_falls_back(health, cfg, where: str) -> bool:
    """Host check of a CholeskyQR breakdown scalar (the round-1
    orthogonality defect): whether the caller falls back to the Householder
    path. The guard trips where the scalar exceeds cfg.hr_guard_tau (or is
    NaN), which warns; the caller falls back where it tripped under
    cfg.hr_guard = "fallback", and keeps the CholeskyQR result otherwise.
    The reference's tracer branch has no counterpart: torch runs eagerly,
    so the scalar is always concrete. Each check and trip is counted under
    ``where`` in ``core/trace.py:GUARD``."""
    if health is None:
        return False
    with span("tileqr_torch.sync.guard"):
        h = float(health)
    tripped = not h <= cfg.hr_guard_tau  # NaN fails the comparison → guard trips
    count_guard(where, tripped)
    if not tripped:
        return False
    action = (
        "falling back to the unconditionally stable Householder path"
        if cfg.hr_guard == "fallback"
        else "keeping the CholeskyQR result (hr_guard='warn')"
    )
    warnings.warn(
        f"tileqr_torch hr guard [{where}]: CholeskyQR round-1 orthogonality "
        f"defect {h:.3e} exceeds hr_guard_tau={cfg.hr_guard_tau:.1e} — the "
        f"conditioning contract (cond ≲ 1e3 in fp32) is broken; {action}."
    )
    return cfg.hr_guard == "fallback"


def _diag_of(r: torch.Tensor) -> torch.Tensor:
    """(B, n) diagonal. The reference sums r·I because an indexed diagonal
    lowers to a slow gather on the TPU; here it is a strided view, and the
    values are the same (adding zeros is exact)."""
    return torch.diagonal(r, dim1=1, dim2=2)


def _inv_factors(r: torch.Tensor):
    """R = D(I+N) with N strictly upper nilpotent: (dinv, [X, X², X⁴, …])
    with X = −N, so that R⁻¹ = (I+X)(I+X²)(I+X⁴)… D⁻¹."""
    n = r.shape[-1]
    dinv = 1.0 / _diag_of(r)
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    x = eye - r * dinv[:, :, None]
    pows = [x]
    for _ in range(1, max(1, (n - 1).bit_length())):
        pows.append(pows[-1] @ pows[-1])
    return dinv, pows


def _apply_rinv(c: torch.Tensor, dinv: torch.Tensor, pows) -> torch.Tensor:
    """C ← C R⁻¹ without forming R⁻¹: ((C(I+X))(I+X²))…·D⁻¹."""
    for p in pows:
        c = c + c @ p
    return c * dinv[:, None, :]


def _triu_inv_doubling(r: torch.Tensor) -> torch.Tensor:
    """Batched upper-triangular inverse, matmul only (see _inv_factors)."""
    dinv, pows = _inv_factors(r)
    eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
    return _apply_rinv(eye.expand(r.shape), dinv, pows)


def _up_half(e: torch.Tensor) -> torch.Tensor:
    """up(E): strict upper + half diagonal of a (B, n, n) stack."""
    return torch.triu(e, 1) + torch.diag_embed(torch.diagonal(e, dim1=1, dim2=2) * 0.5)


def _defect(e: torch.Tensor) -> torch.Tensor:
    """max |E| over every entry (0-d), NaN when E has a NaN: the health."""
    return torch.where(torch.isnan(e).any(), e.new_full((), float("nan")), e.abs().max())


def _correction(e: torch.Tensor) -> torch.Tensor:
    """(I+U)⁻¹ for E = Q₁ᵀQ₁ − I (B, n, n), by matmuls: chol(I+E) = I + U
    with U = up(E − UᵀU) iterated, then the Horner series I − U + U² − U³
    (‖U‖ ≪ 1)."""
    eye = torch.eye(e.shape[-1], dtype=e.dtype, device=e.device)
    u = _up_half(e)
    for _ in range(_CORRECTION_ITERS):
        u = _up_half(e - u.transpose(1, 2) @ u)
    w = eye - u
    w = eye - u @ w
    return eye - u @ w


def cholqr2_batched(a: torch.Tensor, mode: str = "reduced", stats: bool = False,
                    precision: str = "highest"):
    """Batched CholeskyQR2 of a (B, m, n), m >= n: (Q (B, m, n), R (B, n, n))
    or R alone (mode "r"); gram → POTRF (B9) → Q₁ = A·R₁⁻¹ → the matmul-only
    second round → R = triu(QᵀA). Needs cond(A) ≲ 1e3 in fp32. fp32 in
    every precision mode; "b3"/"b4" raise, as the reference's XLA products
    do.

    stats=True appends the round-1 orthogonality defect max ‖Q₁ᵀQ₁ − I‖_max
    over the batch (NaN if E has a NaN), the breakdown detector that
    ``guard_falls_back`` reads."""
    refuse_xla_site(precision, "cholqr2_batched")
    m, n = a.shape[1:]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    with _highest():
        with span("tileqr_torch.hr.round1"):
            g = bdot_pair_rows(a, a)
            r1 = potrf_batched(g)
            # tall A: form S1 = R1⁻¹ and touch A once; near-square: fold the
            # doubling factors into A, skipping the inverse's own products
            if m > 2 * n:
                q1 = a @ _triu_inv_doubling(r1)
            else:
                dinv, pows = _inv_factors(r1)
                q1 = _apply_rinv(a, dinv, pows)
        with span("tileqr_torch.hr.round2"):
            e = bdot_pair_rows(q1, q1) - eye
            q = q1 @ _correction(e)
            r = torch.triu(bdot_pair_rows(q, a))
    out = ((r,) if mode == "r" else (q, r)) + ((_defect(e),) if stats else ())
    return out[0] if len(out) == 1 else out

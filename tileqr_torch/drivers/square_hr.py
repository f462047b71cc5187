"""Blocked QR with CholeskyQR2 panels and Householder reconstruction
(``QRConfig.square_method="hr"``; counterpart of
``tileqr/drivers/square_hr.py``).

Per panel k of the padded matrix (a host loop, offsets as integers):

  1. ``hr_panel``: (Y, T, R_kk) of the (m_k × nb) panel by the reference's
     "fused" pipeline: gram → POTRF (B9, ``kernels/potrf.py``) →
     log-doubling inverse → Q₁ = P·S₁ → correction gram E = Q₁ᵀQ₁ − I →
     matmul-only second round → Q_top → modified LU (B8,
     ``kernels/modlu.py``) → Y = [L1; Q₁_bot·(W·U⁻¹)], T = −U·diag(d)·L1⁻ᵀ,
     R = d ∘ triu(Wᵀ·S₁ᵀ·G).
  2. The trailing update carry[s:, s+nb:] ← (I − Y·T·Yᵀ)ᵀ·carry[s:, s+nb:]
     by B6 (``kernels/panel_apply.py``), in place, in the precision mode:
     the kernel on the card, its plain version on the CPU.
  3. R_kk is written straight into the diagonal block; at the end
     R = triu(carry[:k_max·nb]).

ONE driver takes the place of the reference's ``qr_hr``, ``_hr_segment``
and ``qr_hr_chunked``. Their segments, optimization barriers, buffer
donation and the ``_finish_r_kernel`` merge of stashed R blocks were
devices for the XLA compile and for TPU HBM (``square_hr.py:346-358,
405-413, 523-540``); an eager host loop updating one buffer in place needs
none of them. ``apply_q_hr`` and ``orgqr_hr`` likewise keep one form (the
growing window for Q) at every panel count: the reference's switch to a
full segmented apply past 32 panels only bounds its compile.

Every matmul in this module runs in IEEE fp32 (or float64 on the CPU):
``_highest()`` sets ``torch.backends.cuda.matmul.allow_tf32`` to False for
the duration of a call and restores the caller's setting after: the port's
``Precision.HIGHEST``. With TF32 the hr residual would be near 1e-3. The
panel (``hr_panel``) is fp32 in every mode, as in ``tileqr``; the precision
mode (``kernels/common.py``) reaches the trailing update (B6) and the
applies of ``apply_q_hr``/``orgqr_hr`` (``_apply_block_t``).

Conditioning contract (as the reference's): the first gram squares the
panel's condition number, so cond(A) ≲ 1e3 in fp32; the health scalar
(max over panels of ‖Q₁ᵀQ₁ − I‖_max, NaN-propagating) shows a breakdown.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tileqr_torch.core.layout import pow2_at_least, round_up
from tileqr_torch.core.trace import span
from tileqr_torch.drivers.cholqr import (
    _correction,
    _defect,
    _highest,
    _triu_inv_doubling,
    bdot_pair_rows,
)
from tileqr_torch.kernels.common import dot_bx, passes_of, split_bf16, split_bf16_trunc
from tileqr_torch.kernels.modlu import modified_lu
from tileqr_torch.kernels.panel_apply import kernel_takes, panel_apply, panel_apply_carry
from tileqr_torch.kernels.potrf import potrf_batched

# targets at most this wide take the pairwise W projection in _apply_block_t
_W_PAIR_MAX_COLS = 1024
# split count of the wide split-K W projection
_W_SPLITK = 4


def _w_splitk(y: torch.Tensor, c: torch.Tensor, s: Optional[int] = None) -> torch.Tensor:
    """W = Yᵀ·C as S row-block products and a balanced add tree: error
    ~√(m/S) instead of √m for the same reads as one product."""
    m = y.shape[0]
    s = s or _W_SPLITK
    bounds = [((i * m) // s) // 8 * 8 for i in range(s)] + [m]
    parts = [y[b0:b1].T @ c[b0:b1] for b0, b1 in zip(bounds[:-1], bounds[1:]) if b1 > b0]
    while len(parts) > 1:
        parts = [a + b for a, b in zip(parts[::2], parts[1::2])] + (
            [parts[-1]] if len(parts) % 2 else []
        )
    return parts[0]


def _apply_block_t(y: torch.Tensor, t: torch.Tensor, c: torch.Tensor, trans: bool,
                   precision: str = "highest") -> torch.Tensor:
    """C ← (I − Y·T·Yᵀ)ᵀ C (trans) or (I − Y·T·Yᵀ) C, in place on the view
    c; returns c. The routes (``tileqr/drivers/square_hr.py:217-259``):

    - float32 in an emulated mode with nb-aligned extents: B7
      (``panel_apply``, Kahan sums over 1024-row blocks), by alignment
      alone, as the reference routes b3/b4 to its Pallas ``panel_apply``;
      "high" and "default", which the reference hands to XLA, take it too
      (B7's split instantiation is their product on the card). The wrapper
      raises on the card for an nb past what its kernel takes;
    - float32 in "highest" with nb-aligned extents, more than 1024 columns
      and an nb the fp32 B7 takes: B7, in place of the reference's split-K
      W, whose uncompensated sums put the fp32 ``apply_q`` relerr at 16384²
      over 1e-6 (PERF.md §7); the other "highest" targets take the
      reference's own torch routes below;
    - float32 in an emulated mode otherwise (a vector target, a narrow
      ``orgqr`` window): the three products in plain torch, as the
      reference's ``_dot``: b3/b4 with its truncating split
      (``dot_b3_xla``), "high" and "default" with the round-to-nearest
      split of the TPU's HIGH and DEFAULT (3 and 1 bf16 passes);
    - "highest" otherwise, or float64 in any mode (exact): W = YᵀC pairwise
      for m ≥ 2048 and at most 1024 columns, split-K for m ≥ 4096 in
      float32, one product otherwise."""
    passes = passes_of(precision)
    m, nb = y.shape
    n = c.shape[1]
    emulated = passes > 0 and c.dtype == torch.float32
    aligned = n > 0 and m % nb == 0 and n % nb == 0
    wide_fp32 = c.dtype == torch.float32 and n > _W_PAIR_MAX_COLS and kernel_takes(nb)
    if aligned and (emulated or wide_fp32):
        return panel_apply(y, t, c, trans, precision)
    tm = t.T if trans else t
    if emulated:
        split = split_bf16_trunc if precision in ("b3", "b4") else split_bf16
        w = dot_bx(y.T, c, passes, split)
        w = dot_bx(tm, w, passes, split)
        c -= dot_bx(y, w, passes, split)
        return c
    if m >= 2048 and n <= _W_PAIR_MAX_COLS:
        w = bdot_pair_rows(y[None], c[None])[0]
    elif c.dtype == torch.float32 and m >= 4096:
        w = _w_splitk(y, c)
    else:
        w = y.T @ c
    c -= y @ (tm @ w)
    return c


def hr_panel_parts(panel: torch.Tensor) -> dict:
    """Factor one (m_k, nb) panel (the reference's ``hr_panel_fused``):
    four tall passes (gram, Q₁, E, Y's bottom). Returns every step's result
    a caller reads: "gram" (1, nb, nb) as POTRF (B9) takes it, "q_top"
    (nb, nb) as the modified LU (B8) takes it, "e" = Q₁ᵀQ₁ − I, and the
    factors "y" (m_k, nb), "t" (nb, nb), "r" (nb, nb) with the
    reconstruction signs folded in."""
    nb = panel.shape[1]
    eye = torch.eye(nb, dtype=panel.dtype, device=panel.device)
    with span("tileqr_torch.hr.round1"):
        g = bdot_pair_rows(panel[None], panel[None])  # tall pass 1
        r1 = potrf_batched(g)
        s1 = _triu_inv_doubling(r1)[0]
        q1 = panel @ s1  # tall pass 2
    with span("tileqr_torch.hr.round2"):
        e = bdot_pair_rows(q1[None], q1[None])[0] - eye  # tall pass 3
        w = _correction(e[None])[0]  # the second round, by matmuls
        q_top = q1[:nb] @ w
    with span("tileqr_torch.hr.reconstruct"):
        lu, d = modified_lu(q_top)
        l1 = torch.tril(lu, -1) + eye
        uu = torch.triu(lu)
        invs = _triu_inv_doubling(torch.stack([uu, l1.T]))
        uuinv, l1tinv = invs[0], invs[1]
        l2 = q1[nb:] @ (w @ uuinv)  # tall pass 4
        return {
            "gram": g, "q_top": q_top, "e": e,
            "y": torch.cat([l1, l2], dim=0),
            "t": -((uu * d[None, :]) @ l1tinv),
            "r": d[:, None] * torch.triu(w.T @ (s1.T @ g[0])),
        }


def hr_panel(panel: torch.Tensor, stats: bool = False):
    """(y, t, r) of one panel (``hr_panel_parts``), and with stats=True the
    round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max (NaN if E has a NaN)."""
    p = hr_panel_parts(panel)
    if not stats:
        return p["y"], p["t"], p["r"]
    return p["y"], p["t"], p["r"], _defect(p["e"])


def hr_steps(ap: torch.Tensor, nb: int, stats: bool = False, precision: str = "highest"):
    """The driver's panel loop over a padded (Mp, Np) matrix, IN PLACE on
    ``ap``: for each panel k, factor carry[s:, s:s+nb], apply its
    reflectors to carry[s:, s+nb:] by B6 in the precision mode (the kernel
    on the card, its plain version on the CPU), write R_kk into the
    diagonal block, and yield (Y_k, T_k, defect): the panel's round-1
    orthogonality defect with stats=True, else None."""
    if ap.shape[0] % nb or ap.shape[1] % nb:
        raise ValueError(f"padded shape {tuple(ap.shape)} not a multiple of nb={nb}")
    for k in range(min(ap.shape) // nb):
        s = k * nb
        with _highest():
            out = hr_panel(ap[s:, s : s + nb], stats=stats)
            y, t, rk = out[:3]
            panel_apply_carry(y, t, ap, k, nb, trans=True, precision=precision)
            ap[s : s + nb, s : s + nb] = rk
        yield y, t, (out[3] if stats else None)


def qr_hr(ap: torch.Tensor, nb: int, stats: bool = False, precision: str = "highest"):
    """Blocked hr QR of a padded (Mp, Np) matrix (multiples of nb; column
    padding identity-augmented, see ``pad_for_hr``), IN PLACE on ``ap``,
    the trailing updates in the precision mode.

    Returns (r (K, Np), panels ((Y_0, T_0), …), health): K = min(Mp, Np),
    Y_k (Mp − k·nb, nb); health is the NaN-propagating max of the panels'
    defects (a 0-d tensor on ap's device), or None when stats is False."""
    panels = []
    health = None
    for y, t, h in hr_steps(ap, nb, stats, precision):
        panels.append((y, t))
        if stats:
            health = h if health is None else torch.maximum(health, h)
    return torch.triu(ap[: len(panels) * nb]), tuple(panels), health


def apply_q_hr(panels: Tuple, c: torch.Tensor, nb: int, trans: bool = False,
               precision: str = "highest") -> torch.Tensor:
    """C ← Q C (or Qᵀ C) from hr factors, in place, in the precision mode.
    c: (Mp, P), Mp the padded rows."""
    order = range(len(panels)) if trans else reversed(range(len(panels)))
    with _highest():
        for k in order:
            y, t = panels[k]
            _apply_block_t(y, t, c[k * nb :], trans, precision)
    return c


def orgqr_hr(panels: Tuple, mp: int, nb: int, ncols: int,
             precision: str = "highest") -> torch.Tensor:
    """Q (Mp × ncols) with the xORGQR growing window: in reverse panel
    order panel k touches only rows and columns ≥ k·nb (the columns left of
    it are still unit vectors, on which Yᵀe_c = 0). The applies run in the
    precision mode."""
    y0 = panels[0][0]
    q = torch.eye(mp, ncols, dtype=y0.dtype, device=y0.device)
    # panels at or beyond ncols are exact no-ops on Q's columns
    k_used = min(len(panels), -(-ncols // nb))
    with _highest():
        for k in reversed(range(k_used)):
            s = k * nb
            y, t = panels[k]
            _apply_block_t(y, t, q[s:, s:], False, precision)
    return q


def pad_for_hr(a: torch.Tensor, nb: int, row_mult: Optional[int] = None,
               col_mult: Optional[int] = None) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad (M, N) to nb multiples for the hr driver, into a new buffer.
    Zero row padding is exact; padded columns carry an α·identity block on
    otherwise-zero padding rows (α = the exact power of two at or above
    max|A|), so the last panel's gram stays nonsingular and the padded
    columns factor to unit reflectors without touching R's real block.
    row_mult/col_mult replace nb as the padding multiples: the sharded hr
    driver pads to nb·pr × nb·pc, so that every rank's block-cyclic local
    matrix has the same shape."""
    m, n = a.shape
    np_ = round_up(n, col_mult or nb)
    col_pad = np_ - n
    mp = round_up(m + col_pad, row_mult or nb) if col_pad else round_up(m, row_mult or nb)
    ap = a.new_zeros((mp, np_))
    ap[:m, :n] = a
    if col_pad:
        idx = torch.arange(col_pad, device=a.device)
        ap[m + idx, n + idx] = pow2_at_least(a.abs().max())
    return ap, (m, n)

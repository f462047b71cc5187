"""In-place windowed whole-panel apply (B6), the hr driver's trailing update.

Counterpart of ``tileqr/kernels/panel_apply.py:panel_apply_carry``:

    carry[s:, s+nb:] ← (I − Y·T·Yᵀ)^{T?} · carry[s:, s+nb:],   s = k·nb,

with everything outside the window left untouched. Two phases, a barrier
between them (every row block of Y contributes to W before any C block is
updated):

  phase 1: W = op(T) · Σᵢ Yᵢᵀ Cᵢ over row blocks of ``mr = _block(m, nb,
           512)`` rows, in order, with Kahan-compensated fp32 accumulation
           across the blocks (``_kahan_add``);
  phase 2: C ← C − Y · W.

On a CUDA tensor the wrapper launches ``tq_panel_apply_carry``
(``csrc/panel_apply.cu``), which works on the window in place through
(pointer, leading dimension); on a CPU tensor it runs the plain version,
the same blocks in torch.
"""

from __future__ import annotations

import torch

from tileqr_torch.kernels import _build


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


def panel_apply_carry_plain(y, t, carry, k: int, nb: int, trans: bool = True):
    """Plain torch B6 (in place on carry)."""
    _build.PLAIN_CALLS["panel_apply_carry"] += 1
    c, m, n = _window(y, t, carry, k, nb)
    if n <= 0:
        return carry
    mr = _block(m, nb, 512)
    acc = c.new_zeros((nb, n))
    comp = c.new_zeros((nb, n))
    for r0 in range(0, m, mr):
        val = y[r0 : r0 + mr].T @ c[r0 : r0 + mr]
        yk = val - comp
        tk = acc + yk
        comp = (tk - acc) - yk
        acc = tk
    tm = t.T if trans else t
    c -= y @ (tm @ acc)
    return carry


def panel_apply_carry(y: torch.Tensor, t: torch.Tensor, carry: torch.Tensor, k: int,
                      nb: int, trans: bool = True) -> torch.Tensor:
    """Apply panel k's block reflector (Y (m, nb), T (nb, nb)) to the
    window carry[k·nb:, (k+1)·nb:] in place; returns carry."""
    if not _build.is_cuda(y, t, carry):
        return panel_apply_carry_plain(y, t, carry, k, nb, trans)
    _build.require_fp32(y, t, carry)
    _build.require_contiguous(y=y)
    _build.require_row_major(carry=carry)
    if nb % 32 or nb > 256:
        raise ValueError(f"panel_apply_carry kernel takes nb a multiple of 32, <= 256; got {nb}")
    c, m, n = _window(y, t, carry, k, nb)
    if n <= 0:
        return carry
    tm = (t.T if trans else t).contiguous()
    w = torch.empty((nb, n), dtype=c.dtype, device=c.device)
    rc = _build.lib().tq_panel_apply_carry(
        y.data_ptr(), tm.data_ptr(), c.data_ptr(), carry.stride(0), m, n, nb,
        _block(m, nb, 512), w.data_ptr(), _build.stream(),
    )
    _build.check(rc, "panel_apply_carry")
    _build.LAUNCHES["panel_apply_carry"] += 1
    return carry

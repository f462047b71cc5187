"""LARFB: block-reflector application.

Counterpart of ``tileqr/kernels/larfb.py``. ``larfb_body`` is the plain
torch body; the CUDA kernels that apply it (``csrc/strip.cu``) carry it
fused into the strip sweep. ``larfb`` is the single-tile entry (tileqr's
``larfb``, B15): K4 (``kernels/chain.py:larfb_strip``) on a copy of C.
"""

from __future__ import annotations

import torch

from tileqr_torch.kernels.common import dot, dot_t, unit_lower


def larfb_body(packed: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
               trans: bool, precision: str = "highest") -> torch.Tensor:
    """C ← (I − V T Vᵀ)^{T if trans} C with V = unit_lower(packed); the
    three products in the precision mode's product."""
    v = unit_lower(packed)
    w = dot_t(v, c, precision)
    w = dot_t(t, w, precision) if trans else dot(t, w, precision)
    return c - dot(v, w, precision)


def larfb(packed: torch.Tensor, t: torch.Tensor, c: torch.Tensor, trans: bool = True,
          precision: str = "highest") -> torch.Tensor:
    """Standalone LARFB on one tile: packed (nb, nb), T (nb, nb), C (nb, p).
    Returns a new C'; C is not written."""
    nb = packed.shape[0]
    if tuple(packed.shape) != (nb, nb) or tuple(t.shape) != (nb, nb) or c.shape[0] != nb:
        raise ValueError(f"larfb: packed {tuple(packed.shape)}, T {tuple(t.shape)}, "
                         f"C {tuple(c.shape)}")
    from tileqr_torch.kernels.chain import larfb_strip

    out = c.clone(memory_format=torch.contiguous_format)
    larfb_strip(packed.contiguous(), t.contiguous(), out, nb, trans=trans, precision=precision)
    return out

"""LARFB: block-reflector application, plain torch version.

Counterpart of ``tileqr/kernels/larfb.py:larfb_body``. The CUDA kernels
that apply it (``csrc/chain.cu``) carry it fused into the strip sweep.
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

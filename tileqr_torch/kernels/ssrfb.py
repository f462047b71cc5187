"""SSRFB/TSMQR: couple-reflector application, plain torch version.

Counterpart of ``tileqr/kernels/ssrfb.py:ssrfb_body``:
W = T2^{T?}(C_top + V2ᵀC_bot); C_top −= W; C_bot −= V2·W, the three
products in the precision mode's product.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels.common import dot, dot_t


def ssrfb_body(v2: torch.Tensor, t2: torch.Tensor, c_top: torch.Tensor,
               c_bot: torch.Tensor, trans: bool,
               precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (c_top', c_bot')."""
    w = c_top + dot_t(v2, c_bot, precision)
    w = dot_t(t2, w, precision) if trans else dot(t2, w, precision)
    return c_top - w, c_bot - dot(v2, w, precision)

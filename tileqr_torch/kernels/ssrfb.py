"""SSRFB/TSMQR: couple-reflector application.

Counterpart of ``tileqr/kernels/ssrfb.py``. ``ssrfb_body`` is the plain
torch body: W = T2^{T?}(C_top + V2ᵀC_bot); C_top −= W; C_bot −= V2·W, the
three products in the precision mode's product. ``ssrfb`` is the
single-couple entry (tileqr's ``ssrfb``, B15) and the sharded strip tree's
TTMQR: K3 (``kernels/chain.py:couple_strip``, ``csrc/chain.cu`` on a CUDA
tensor, its plain version on a CPU tensor) with one couple of V2's rows and
no LARFB, counted as ``ssrfb``.
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


def ssrfb(v2: torch.Tensor, t2: torch.Tensor, c_top: torch.Tensor, c_bot: torch.Tensor,
          trans: bool = True, precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone SSRFB on one couple: V2 (m, nb) with m a multiple of nb,
    T2 (nb, nb), C_top (nb, p), C_bot (m, p). Returns new (C_top', C_bot');
    the inputs are not written."""
    m, nb = v2.shape
    if m % nb or tuple(t2.shape) != (nb, nb) or c_top.shape[0] != nb or \
            tuple(c_bot.shape) != (m, c_top.shape[1]):
        raise ValueError(f"ssrfb: V2 {tuple(v2.shape)}, T2 {tuple(t2.shape)}, "
                         f"C_top {tuple(c_top.shape)}, C_bot {tuple(c_bot.shape)}")
    from tileqr_torch.kernels.chain import couple_strip

    top = c_top.clone(memory_format=torch.contiguous_format)
    bot = c_bot.clone(memory_format=torch.contiguous_format)
    couple_strip(v2.contiguous()[None], t2.contiguous()[None], bot, top, 0, 0, 1, m, nb, 0,
                 trans=trans, precision=precision, counter="ssrfb")
    return top, bot

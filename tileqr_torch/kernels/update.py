"""The fused LARFB + SSRFB sweep of one panel, on a packed matrix.

Counterpart of ``tileqr/kernels/update.py:couple_apply`` (B14), the trailing
update and Q apply of tileqr's static sharded driver: panel k's reflectors
(the packed GEQRT tile (k, k) and the nb-row TSQRT couples below it) applied
to column tiles [col_start, Pt) of C. It is K3 (``kernels/chain.py``) with
``block_rows = nb`` and the LARFB fused: forward (LARFB first, then the
couples down the column) or ``reverse`` (the couples up the column, LARFB
last). On a CUDA tensor K3 runs on the card; on a CPU tensor
``couple_apply_plain``. The port's sharded driver runs the same K3 sweep
on its flat buffers at chunk 1; this entry keeps tileqr's signature.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels.chain import couple_strip, couple_strip_plain


def _operands(packed, tg, t2stack, c, k: int, col_start: int, nb: int):
    """K3's operands for panel k: (v_stack, t2s, vkk, tg, strip, n_inner)."""
    m = packed.shape[0]
    mt, pt = m // nb, c.shape[1] // nb - col_start
    n_inner = mt - k - 1
    if n_inner < 1 or pt < 1 or tuple(t2stack.shape) != (n_inner + 1, nb, nb):
        raise ValueError(f"couple_apply: panel {k} of a {mt}-tile column with "
                         f"t2stack {tuple(t2stack.shape)} on {pt} column tiles")
    col = packed[:, k * nb : (k + 1) * nb]
    strip = c[k * nb : (k + 1) * nb, col_start * nb :].clone(
        memory_format=torch.contiguous_format)
    return (col[(k + 1) * nb :].reshape(n_inner, nb, nb).contiguous(),
            t2stack[1:].contiguous(), col[k * nb : (k + 1) * nb].contiguous(),
            tg.contiguous(), strip, n_inner)


def couple_apply_plain(packed: torch.Tensor, tg: torch.Tensor, t2stack: torch.Tensor,
                       c: torch.Tensor, k: int, col_start: int, nb: int, trans: bool = True,
                       reverse: bool = False, precision: str = "highest"):
    """Plain torch B14 (K3's plain version on the same operands)."""
    v_stack, t2s, vkk, tg, strip, n_inner = _operands(packed, tg, t2stack, c, k, col_start, nb)
    couple_strip_plain(v_stack, t2s, c, strip, 0, k + 1, n_inner, nb, nb, col_start,
                       trans=trans, reverse=reverse, vkk=vkk, tg=tg, precision=precision)
    return c, strip


def couple_apply(packed: torch.Tensor, tg: torch.Tensor, t2stack: torch.Tensor,
                 c: torch.Tensor, k: int, col_start: int, nb: int, trans: bool = True,
                 reverse: bool = False,
                 precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply panel k's reflectors to column tiles [col_start, Pt) of c.

    packed: (M, N) factored matrix (the V source, column tile k); tg:
    (nb, nb) GEQRT T; t2stack: (Mt − k, nb, nb) TSQRT T2s (slot 0 unused);
    c: (M, P) target. Returns (c', row_strip): c' is c, updated IN PLACE in
    the row tiles below k (row tile k is not written); row_strip
    (nb, (Pt − col_start)·nb) is the updated row tile k, which the caller
    splices back.
    """
    v_stack, t2s, vkk, tg, strip, n_inner = _operands(packed, tg, t2stack, c, k, col_start, nb)
    couple_strip(v_stack, t2s, c, strip, 0, k + 1, n_inner, nb, nb, col_start, trans=trans,
                 reverse=reverse, vkk=vkk, tg=tg, precision=precision)
    return c, strip

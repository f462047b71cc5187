"""Right-looking tiled QR driver (counterpart of ``tileqr/drivers/square.py``).

A host loop over panels launches K1-K4 (``kernels/panel.py``,
``kernels/chain.py``) with integer offsets; a panel's K1 and K2 are one
pipelined launch on the card (``chain.panel_column``). It stands in for both of the
JAX package's drivers: ``square.py`` (trace-unrolled) and ``square_dyn.py``
(run-time offsets, which exists only to bound TPU compile time).

Both ``qr_tiled`` and ``apply_q_tiled`` update their matrix IN PLACE: the
row strip of panel k is a view of it, and the couple kernels write their
bottom row blocks straight into it. ``precision`` reaches the update
kernels K3/K4; the panel kernels K1/K2 are fp32 in every mode, as in
``tileqr``.

Factor layout (as the JAX static driver's):
  r_diag[k]: final diagonal R tile. t_geqrt[k]: compact-WY T of the GEQRT.
  panels[k] = (v_stack, t2_head, v_chunks, t2_chunks): v_stack
  (1+n_head, nb, nb) = packed GEQRT tile + head V2 tiles; v_chunks
  (n_chunks, chunk·nb, nb) = tall dense V2 chunks. A's upper triangle holds
  the off-diagonal R tiles; its sub-diagonal content is unspecified.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.core.trace import span
from tileqr_torch.kernels.chain import couple_strip, larfb_strip, panel_column


def _chunk_for(mt: int, chunk: int) -> int:
    """Largest c <= chunk dividing mt."""
    for c in range(min(chunk, mt), 0, -1):
        if mt % c == 0:
            return c
    return 1


def _segments(k: int, mt: int, c: int) -> Tuple[int, int, int]:
    """(n_head, base_block, n_chunks) for panel k's sub-diagonal."""
    rem = mt - k - 1
    n_head = min((c - (k + 1) % c) % c, rem)
    align = k + 1 + n_head
    n_chunks = (mt - align) // c
    return n_head, align // c, n_chunks


def qr_tiled(a: torch.Tensor, nb: int, ib: int = 128, chunk: int = 4,
             precision: str = "highest"):
    """Factor A (M, N; multiples of nb) in place, the trailing updates in
    the precision mode.

    Returns (a, r_diag, t_geqrt, panels) in the module-docstring layout.
    """
    m, n = a.shape
    mt, nt = m // nb, n // nb
    k_max = min(mt, nt)
    c = _chunk_for(mt, chunk)

    r_diag, t_geqrt, panels = [], [], []
    for k in range(k_max):
        n_head, base, nc = _segments(k, mt, c)
        with span("tileqr_torch.hh.panel"):
            r_k, v_stack, tg_k, t2h, v_chunks, t2t = panel_column(a, k, nb, ib, n_head, base,
                                                                  nc, c * nb)
        r_diag.append(r_k)
        t_geqrt.append(tg_k)
        panels.append((v_stack, t2h, v_chunks, t2t))
        if nt - k - 1 == 0:
            continue
        with span("tileqr_torch.hh.update"):
            strip = a[k * nb : (k + 1) * nb, (k + 1) * nb :]
            if n_head > 0:
                couple_strip(v_stack, t2h, a, strip, 1, k + 1, n_head, nb, nb, k + 1,
                             trans=True, vkk=v_stack[0], tg=tg_k, precision=precision)
                if nc > 0:
                    couple_strip(v_chunks, t2t, a, strip, 0, base, nc, c * nb, nb,
                                 k + 1, trans=True, precision=precision)
            elif nc > 0:
                couple_strip(v_chunks, t2t, a, strip, 0, base, nc, c * nb, nb, k + 1,
                             trans=True, vkk=v_stack[0], tg=tg_k, precision=precision)
            else:
                larfb_strip(v_stack[0], tg_k, strip, nb, trans=True, precision=precision)
    return a, torch.stack(r_diag), torch.stack(t_geqrt), tuple(panels)


def assemble_r(packed: torch.Tensor, r_diag: torch.Tensor, nb: int) -> torch.Tensor:
    """R = triu(packed) with the stale diagonal tiles replaced by r_diag."""
    r = torch.triu(packed)
    for k in range(r_diag.shape[0]):
        r[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb] = torch.triu(r_diag[k])
    return r


def apply_q_tiled(panels: Tuple, t_geqrt: torch.Tensor, c_mat: torch.Tensor, nb: int,
                  chunk: int = 4, trans: bool = True, triangular: bool = False,
                  precision: str = "highest"):
    """C ← Qᵀ C (trans) or Q C, in place, replaying the tiled reflectors in
    the precision mode. c_mat: (M, P), P a multiple of nb. ``chunk`` must
    match the factor's.

    triangular (trans=False only): the xORGQR growing window for C with
    eye-like column structure (column tile j zero below row tile j): in
    reverse panel order, panel k is an exact no-op on column tiles < k, so
    its sweep starts at column tile k. Only valid for such C (orgqr).
    """
    m, p = c_mat.shape
    mt = m // nb
    c = _chunk_for(mt, chunk)
    if triangular and trans:
        raise ValueError("the triangular window applies to Q·C only")

    ks = range(len(panels)) if trans else range(len(panels) - 1, -1, -1)
    for k in ks:
        if triangular and k * nb >= p:
            # the window starts right of C's last column: an exact no-op
            continue
        n_head, base, nc = _segments(k, mt, c)
        v_stack, t2h, v_chunks, t2t = panels[k]
        tg = t_geqrt[k]
        cs = k if triangular else 0
        strip = c_mat[k * nb : (k + 1) * nb, cs * nb :]
        mode = dict(precision=precision)
        if trans:
            if n_head > 0:
                couple_strip(v_stack, t2h, c_mat, strip, 1, k + 1, n_head, nb, nb, 0,
                             trans=True, vkk=v_stack[0], tg=tg, **mode)
                if nc > 0:
                    couple_strip(v_chunks, t2t, c_mat, strip, 0, base, nc, c * nb, nb, 0,
                                 trans=True, **mode)
            elif nc > 0:
                couple_strip(v_chunks, t2t, c_mat, strip, 0, base, nc, c * nb, nb, 0,
                             trans=True, vkk=v_stack[0], tg=tg, **mode)
            else:
                larfb_strip(v_stack[0], tg, strip, nb, trans=True, **mode)
        else:
            if nc > 0:
                couple_strip(v_chunks, t2t, c_mat, strip, 0, base, nc, c * nb, nb, cs,
                             trans=False, reverse=True,
                             vkk=None if n_head > 0 else v_stack[0],
                             tg=None if n_head > 0 else tg, **mode)
            if n_head > 0:
                couple_strip(v_stack, t2h, c_mat, strip, 1, k + 1, n_head, nb, nb, cs,
                             trans=False, reverse=True, vkk=v_stack[0], tg=tg, **mode)
            if n_head == 0 and nc == 0:
                larfb_strip(v_stack[0], tg, strip, nb, trans=False, **mode)
    return c_mat

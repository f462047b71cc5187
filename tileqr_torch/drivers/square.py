"""Right-looking tiled QR driver (counterpart of ``tileqr/drivers/square.py``).

A host loop over panels launches K1-K4 (``kernels/panel.py``,
``kernels/chain.py``; K3/K4 through ``chain.strip_sweep``) with integer
offsets; a panel's K1 and K2 are one pipelined launch on the card
(``chain.panel_column``), and panel k+1 runs on a second stream beside
the bulk of update k (``qr_tiled``'s lookahead).
It stands in for both of the JAX package's drivers: ``square.py``
(trace-unrolled) and ``square_dyn.py`` (run-time offsets, which exists
only to bound TPU compile time).

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

import contextlib
from typing import Dict, Optional, Tuple

import torch

from tileqr_torch.core import trace
from tileqr_torch.core.trace import span
from tileqr_torch.kernels.chain import panel_column, strip_sweep


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


def _sweep(panel: Tuple, tg: torch.Tensor, mat: torch.Tensor, strip: torch.Tensor, k: int,
           mt: int, c: int, nb: int, col_start: int, trans: bool, precision: str) -> None:
    """Panel k's reflectors (its ``panels`` entry and GEQRT T) on its row
    strip of ``mat`` from column tile ``col_start``: ``chain.strip_sweep``
    on its head and chunk couples."""
    n_head, base, nc = _segments(k, mt, c)
    v_stack, t2h, v_chunks, t2t = panel
    heads = (v_stack, t2h, mat, strip, 1, k + 1, n_head, nb, nb, col_start) if n_head else None
    chunks = (v_chunks, t2t, mat, strip, 0, base, nc, c * nb, nb, col_start) if nc else None
    strip_sweep(heads, chunks, v_stack[0], tg, strip, nb, trans, precision)


# the side stream of each card, by device index
_SIDE: Dict[int, torch.cuda.Stream] = {}


def _side_stream(a: torch.Tensor) -> Optional[torch.cuda.Stream]:
    """The high-priority stream of A's card that panels and narrow updates
    run on, made once a card; None on the CPU and while the current stream
    is captured in a CUDA graph (everything then runs on the one current
    stream, in the same order)."""
    if a.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    idx = a.device.index if a.device.index is not None else torch.cuda.current_device()
    side = _SIDE.get(idx)
    if side is None:
        side = _SIDE[idx] = torch.cuda.Stream(idx, priority=torch.cuda.Stream.priority_range()[1])
    return side


def _on(stream: Optional[torch.cuda.Stream]):
    """Make ``stream`` the current one for the block (None: leave it)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def qr_tiled(a: torch.Tensor, nb: int, ib: int = 128, chunk: int = 4,
             precision: str = "highest"):
    """Factor A (M, N; multiples of nb) in place, the trailing updates in
    the precision mode.

    Depth-1 lookahead: where panel k leaves two or more column tiles to
    update (nt - k - 1 >= 2), its update is two calls, the narrow one of
    column tile k+1 (all panel k+1 reads) and the rest, of tiles k+2
    onward; panel k+1 is factored between them. On the card, panels and
    narrow updates run on a high-priority side stream (``_side_stream``)
    and the rest on the caller's stream, ordered by events alone: narrow k
    waits for rest k-1 (which wrote tile k+1), panel k+1 follows narrow k
    on the side stream, and rest k waits for narrow k, so panel k+1's
    clusters and rest k's K3 become ready together and share the card. The
    caller's stream waits for the side stream before the return. On the
    CPU and under CUDA graph capture the same calls run in the same order
    on the one current stream. ``trace.LOOKAHEAD`` counts the split
    updates and the panels launched beside a rest.

    Returns (a, r_diag, t_geqrt, panels) in the module-docstring layout.
    """
    m, n = a.shape
    mt, nt = m // nb, n // nb
    k_max = min(mt, nt)
    c = _chunk_for(mt, chunk)
    side = _side_stream(a)
    main = torch.cuda.current_stream(a.device) if side is not None else None
    if side is not None:
        side.wait_stream(main)

    def factor(k):
        n_head, base, nc = _segments(k, mt, c)
        with _on(side), span("tileqr_torch.hh.panel"):
            out = panel_column(a, k, nb, ib, n_head, base, nc, c * nb)
        if side is not None:
            for t in out:  # read on the caller's stream by the rest and by later calls
                t.record_stream(main)
        return out

    def update(k, lo, hi, panel):
        """Panel k's reflectors on column tiles [lo, hi) of A."""
        _, v_stack, tg, t2h, v_chunks, t2t = panel
        cm = a[:, : hi * nb]
        strip = a[k * nb : (k + 1) * nb, lo * nb : hi * nb]
        with span("tileqr_torch.hh.update"):
            _sweep((v_stack, t2h, v_chunks, t2t), tg, cm, strip, k, mt, c, nb, lo, True, precision)

    r_diag, t_geqrt, panels = [], [], []
    rest_done = None  # rest k-1's event on the caller's stream
    nxt = factor(0)
    for k in range(k_max):
        cur = nxt
        r_diag.append(cur[0])
        t_geqrt.append(cur[2])
        panels.append((cur[1], cur[3], cur[4], cur[5]))
        split = nt - k - 1 >= 2
        narrow_done = None
        if nt - k - 1 > 0:
            with _on(side):
                if rest_done is not None:
                    side.wait_event(rest_done)
                update(k, k + 1, k + 2 if split else nt, cur)
                if split and side is not None:
                    narrow_done = side.record_event()
        if k + 1 < k_max:
            nxt = factor(k + 1)
            trace.LOOKAHEAD["beside"] += int(narrow_done is not None)
        if split:
            trace.LOOKAHEAD["split"] += 1
            if narrow_done is not None:
                main.wait_event(narrow_done)
            update(k, k + 2, nt, cur)
            if side is not None:
                rest_done = main.record_event()
    if side is not None:
        main.wait_stream(side)
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
        cs = k if triangular else 0
        strip = c_mat[k * nb : (k + 1) * nb, cs * nb :]
        _sweep(panels[k], t_geqrt[k], c_mat, strip, k, mt, c, nb, cs, trans, precision)
    return c_mat

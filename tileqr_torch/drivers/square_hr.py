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

import threading
from typing import Optional, Tuple

import torch

from tileqr_torch.core.layout import pow2_at_least, round_up
from tileqr_torch.core.trace import HR_APPLY, span
from tileqr_torch.drivers.cholqr import (
    _correction,
    _defect,
    _highest,
    _triu_inv_doubling,
    bdot_pair_rows,
)
from tileqr_torch.kernels import _build
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


def _apply_route(m: int, nb: int, n: int, dtype: torch.dtype, precision: str) -> str:
    """The route ``_apply_block_t`` takes for Y (m, nb) on an (m, n) target
    of ``dtype`` in the precision mode: a key of ``trace.HR_APPLY``."""
    emulated = passes_of(precision) > 0 and dtype == torch.float32
    aligned = n > 0 and m % nb == 0 and n % nb == 0
    wide_fp32 = dtype == torch.float32 and n > _W_PAIR_MAX_COLS and kernel_takes(nb)
    if aligned and (emulated or wide_fp32):
        return "b7"
    if emulated:
        return "emulated"
    if m >= 2048 and n <= _W_PAIR_MAX_COLS:
        return "pair"
    if dtype == torch.float32 and m >= 4096:
        return "splitk"
    return "one"


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
      float32, one product otherwise.

    ``trace.HR_APPLY`` counts the route taken (``_apply_route``)."""
    passes = passes_of(precision)
    m, nb = y.shape
    route = _apply_route(m, nb, c.shape[1], c.dtype, precision)
    HR_APPLY[route] += 1
    if route == "b7":
        return panel_apply(y, t, c, trans, precision)
    tm = t.T if trans else t
    if route == "emulated":
        split = split_bf16_trunc if precision in ("b3", "b4") else split_bf16
        w = dot_bx(y.T, c, passes, split)
        w = dot_bx(tm, w, passes, split)
        c -= dot_bx(y, w, passes, split)
        return c
    if route == "pair":
        w = bdot_pair_rows(y[None], c[None])[0]
    elif route == "splitk":
        w = _w_splitk(y, c)
    else:
        w = y.T @ c
    c -= y @ (tm @ w)
    return c


def _round1(panel: torch.Tensor):
    """Round 1: the gram G (tall pass 1), B9, S₁ = R₁⁻¹, Q₁ = panel·S₁
    (tall pass 2). Returns (G, S₁, Q₁)."""
    g = bdot_pair_rows(panel[None], panel[None])
    s1 = _triu_inv_doubling(potrf_batched(g))[0]
    return g, s1, panel @ s1


def _round2(q1: torch.Tensor):
    """Round 2: E = Q₁ᵀQ₁ − I (tall pass 3), the correction W by matmuls,
    Q_top = Q₁[:nb]·W. Returns (E, W, Q_top)."""
    nb = q1.shape[1]
    e = bdot_pair_rows(q1[None], q1[None])[0] - torch.eye(nb, dtype=q1.dtype, device=q1.device)
    w = _correction(e[None])[0]
    return e, w, q1[:nb] @ w


def _reconstruct(g, s1, q1, w, q_top):
    """B8 on Q_top, the inverses, Y = [L1; L2] (tall pass 4), T and R.
    Returns (Y, T, R)."""
    nb = q1.shape[1]
    lu, d = modified_lu(q_top)
    l1 = torch.tril(lu, -1) + torch.eye(nb, dtype=q1.dtype, device=q1.device)
    uu = torch.triu(lu)
    invs = _triu_inv_doubling(torch.stack([uu, l1.T]))
    uuinv, l1tinv = invs[0], invs[1]
    l2 = q1[nb:] @ (w @ uuinv)
    return (torch.cat([l1, l2], dim=0), -((uu * d[None, :]) @ l1tinv),
            d[:, None] * torch.triu(w.T @ (s1.T @ g[0])))


def hr_panel_parts(panel: torch.Tensor) -> dict:
    """Factor one (m_k, nb) panel (the reference's ``hr_panel_fused``):
    four tall passes (gram, Q₁, E, Y's bottom). Returns every step's result
    a caller reads: "gram" (1, nb, nb) as POTRF (B9) takes it, "q_top"
    (nb, nb) as the modified LU (B8) takes it, "e" = Q₁ᵀQ₁ − I, and the
    factors "y" (m_k, nb), "t" (nb, nb), "r" (nb, nb) with the
    reconstruction signs folded in."""
    with span("tileqr_torch.hr.round1"):
        g, s1, q1 = _round1(panel)
    with span("tileqr_torch.hr.round2"):
        e, w, q_top = _round2(q1)
    with span("tileqr_torch.hr.reconstruct"):
        y, t, r = _reconstruct(g, s1, q1, w, q_top)
    return {"gram": g, "q_top": q_top, "e": e, "y": y, "t": t, "r": r}


def hr_panel(panel: torch.Tensor, stats: bool = False):
    """(y, t, r) of one panel (``hr_panel_parts``), and with stats=True the
    round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max (NaN if E has a NaN)."""
    p = hr_panel_parts(panel)
    if not stats:
        return p["y"], p["t"], p["r"]
    return p["y"], p["t"], p["r"], _defect(p["e"])


def _in_span(name: str, phase):
    with span(name):
        return phase()


def _panel_step(ap: torch.Tensor, k: int, nb: int, stats: bool, precision: str, run=_in_span):
    """Panel k of ``hr_steps`` on ``ap``: the three rounds (R_kk written
    into the diagonal block, and the defect with stats=True, after the
    last), then B6 where columns lie right of the panel; each phase run
    by ``run(span, phase)``, which returns what the phase returns. Returns
    (Y_k, T_k, defect or None)."""
    s = k * nb

    def reconstruct():
        y, t, r = _reconstruct(g, s1, q1, w, q_top)
        ap[s : s + nb, s : s + nb] = r
        return y, t, (_defect(e) if stats else None)

    g, s1, q1 = run("tileqr_torch.hr.round1", lambda: _round1(ap[s:, s : s + nb]))
    e, w, q_top = run("tileqr_torch.hr.round2", lambda: _round2(q1))
    y, t, defect = run("tileqr_torch.hr.reconstruct", reconstruct)
    if s + nb < ap.shape[1]:
        run("tileqr_torch.hr.update",
            lambda: panel_apply_carry(y, t, ap, k, nb, trans=True, precision=precision))
    return y, t, defect


class _LoopGraphs:
    """The panel loop of ``hr_steps`` at one padded shape on the card, as
    CUDA graphs captured into one memory pool on a static copy of the
    padded matrix, and replayed in order. A replay launches a phase's
    operations at once (~165 a panel): the host's Python a panel, which
    set the factor's pace at 16384², is paid once, at the capture. Four
    graphs a panel, one a span of ``_panel_step``: a graph's kernels are
    charged to the span its replay runs in, so fewer graphs would merge
    spans that the trace reads apart (``hr.update`` is B6 alone).

    ``steps`` runs under ``lock``, taken by ``_loop_graphs`` and released
    when the loop ends or is dropped; a loop that finds it taken runs
    eagerly. Each loop's device work waits on the ``done`` event that the
    previous one recorded on its stream, so loops on different streams
    never share the static operands at once. ``LAUNCHES`` and ``PROJECT``
    gain, at the end of each replayed loop, what the capture counted."""

    def __init__(self, ap: torch.Tensor, nb: int, stats: bool, precision: str):
        self.lock = threading.Lock()
        self.done = None
        self.ap = torch.empty_like(ap)
        self.pool = torch.cuda.graph_pool_handle()
        self.panels = []
        counters = (_build.LAUNCHES, _build.PROJECT)
        held = [dict(c) for c in counters]
        side = torch.cuda.Stream(ap.device)
        side.wait_stream(torch.cuda.current_stream(ap.device))
        try:
            with torch.cuda.stream(side), _highest():
                for k in range(min(ap.shape) // nb):
                    graphs = []
                    out = _panel_step(self.ap, k, nb, stats, precision,
                                      lambda name, phase: self._capture(graphs, name, phase))
                    self.panels.append((graphs, out))
        finally:
            torch.cuda.current_stream(ap.device).wait_stream(side)
            self.launched = [(c, {key: n - h[key] for key, n in c.items() if n != h[key]})
                             for c, h in zip(counters, held)]
            for c, h in zip(counters, held):
                c.update(h)  # a capture launches nothing

    def _capture(self, graphs: list, name: str, phase):
        # capture_begin/end, not torch.cuda.graph: that one synchronizes,
        # collects garbage and empties the allocator's cache at every
        # capture. "thread_local": another thread's calls are not refused
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = phase()
        finally:
            graph.capture_end()  # ends a failed capture too, then raises
        graphs.append((name, graph))
        return out

    def steps(self, ap: torch.Tensor):
        stream = torch.cuda.current_stream(ap.device)
        try:
            if self.done is not None:
                stream.wait_event(self.done)
            self.ap.copy_(ap)
            for graphs, (y, t, defect) in self.panels:
                for name, graph in graphs:
                    with span(name):
                        graph.replay()
                yield y.clone(), t.clone(), (None if defect is None else defect.clone())
            ap.copy_(self.ap)
            for counter, launched in self.launched:
                for key, n in launched.items():
                    counter[key] += n
        finally:
            self.done = stream.record_event()
            self.lock.release()


# {(device, padded shape, nb, stats, precision): _LoopGraphs; None where
# the shape has run once, eagerly; _EAGER where its capture failed}: the
# last shape the card factored. ``release_graphs`` empties it.
_LOOPS: dict = {}
_LOOPS_LOCK = threading.Lock()
_EAGER = "eager"


def _loop_graphs(ap: torch.Tensor, nb: int, stats: bool, precision: str):
    """The graphs of ``ap``'s shape with their lock taken, captured at the
    shape's second call on the card (the first, eager, is their warm-up).
    None, for an eager loop: on the CPU, inside a caller's own capture, at
    a shape's first call, where a capture failed (for good: the shape
    stays eager until ``release_graphs``), and while another loop holds
    the graphs."""
    if not ap.is_cuda or torch.cuda.is_current_stream_capturing():
        return None
    key = (ap.device, tuple(ap.shape), nb, stats, precision)
    with _LOOPS_LOCK:
        if key not in _LOOPS:
            _LOOPS.clear()
            _LOOPS[key] = None
            return None
        if _LOOPS[key] is None:
            try:
                _LOOPS[key] = _LoopGraphs(ap, nb, stats, precision)
            except RuntimeError:  # out of memory, or a capture the card refused
                _LOOPS[key] = _EAGER
        loop = _LOOPS[key]
        if loop is _EAGER or not loop.lock.acquire(blocking=False):
            return None
        return loop


def release_graphs() -> None:
    """Drop the hr panel loop's CUDA graphs, their memory pool and static
    copy (1.7 GB at 16384²; a loop still running keeps its own until it
    ends). The allocator keeps the freed memory cached for the process
    until ``torch.cuda.empty_cache()``. The next hr factor at any shape
    runs eagerly, and its second captures anew."""
    with _LOOPS_LOCK:
        _LOOPS.clear()


def hr_steps(ap: torch.Tensor, nb: int, stats: bool = False, precision: str = "highest"):
    """The driver's panel loop over a padded (Mp, Np) matrix, IN PLACE on
    ``ap``: for each panel k, factor carry[s:, s:s+nb], write R_kk into the
    diagonal block, apply the reflectors to carry[s:, s+nb:] by B6 in the
    precision mode (the kernel on the card, its plain version on the CPU;
    no call where no column lies right of the panel), and yield (Y_k, T_k,
    defect): the panel's round-1 orthogonality defect with stats=True,
    else None. On the card a shape's calls after its first replay CUDA
    graphs of the loop (``_LoopGraphs``): the same kernels on the same
    operands; ``ap`` takes its result when the loop ends."""
    if ap.shape[0] % nb or ap.shape[1] % nb:
        raise ValueError(f"padded shape {tuple(ap.shape)} not a multiple of nb={nb}")
    graphs = _loop_graphs(ap, nb, stats, precision)
    if graphs is not None:
        yield from graphs.steps(ap)
        return
    for k in range(min(ap.shape) // nb):
        with _highest():
            out = _panel_step(ap, k, nb, stats, precision)
        yield out


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
            with span("tileqr_torch.hr.apply"):
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
            with span("tileqr_torch.hr.apply"):
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

"""Public API of the port, as ``tileqr/api.py``: qr, qr_factor, apply_q,
orgqr and lstsq on the tiled-Householder ("hh") and the CholeskyQR2 +
reconstruction ("hr") square paths; tsqr, the tall-skinny QR (tree, chain
or CholeskyQR2); qr_batched, the QR of a stack of small matrices; and
qr_sharded, assemble_r_sharded and apply_q_sharded, the 2D block-cyclic QR
over a process grid (``tileqr/drivers/sharded.py``'s entries).

All entries accept arbitrary (M, N); inputs are zero-padded to tile
multiples (exact for QR: padded rows/columns give tau = 0 reflectors and
zero R blocks; the hr path pads columns with an α·identity block) and
results are sliced back. The factorization runs in place on a private
copy, so the caller's tensor is never written.

Device: a ``torch.Tensor`` input stays on its own device. Any other input
(numpy arrays, lists) goes to ``device``, which defaults to "cuda": with no
CUDA device that raises, it does not run on the CPU. CPU runs (the plain
kernel versions) happen only for CPU tensors or ``device="cpu"``.
``apply_q`` and ``orgqr`` follow the factors' device and take all three
factor records: ``QRFactors``, ``HRFactors`` and ``TSQRFactors``.

``QRConfig.precision`` reaches the update and apply products of every
path (the table in ``core/config.py``); where the reference hands "b3" or
"b4" to an XLA product that refuses it (``tsqr`` forming Q, ``qr_batched``,
CholeskyQR2), the port raises ``ValueError`` too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tileqr_torch.core.config import QRConfig
from tileqr_torch.core.layout import pad_to_tiles, pow2_at_least, round_up
from tileqr_torch.core.trace import entry, span
from tileqr_torch.drivers.batched import qr_batched as _qr_batched
from tileqr_torch.dist.mesh import Mesh, rank_device
from tileqr_torch.drivers import sharded as _sh
from tileqr_torch.drivers import sharded_hr as _shr
from tileqr_torch.drivers.cholqr import _highest, cholqr2_batched, guard_falls_back
from tileqr_torch.drivers.sharded import ShardedFactors
from tileqr_torch.drivers.sharded_hr import ShardedHRFactors
from tileqr_torch.drivers.square import apply_q_tiled, assemble_r, qr_tiled
from tileqr_torch.drivers.square_hr import apply_q_hr, hr_panel, orgqr_hr, pad_for_hr, qr_hr
from tileqr_torch.drivers.tsqr import (
    TSQRFactors,
    auto_leaf_rows,
    tsqr_apply_q,
    tsqr_factor,
    tsqr_form_q,
)
from tileqr_torch.kernels.common import passes_of


class QRFactors(NamedTuple):
    """Packed tiled-QR factors, in the JAX static driver's layout
    (``drivers/square.py`` docstring)."""

    packed: torch.Tensor
    r_diag: torch.Tensor
    t_geqrt: torch.Tensor
    panels: Tuple
    nb: int
    chunk: int
    shape: Tuple[int, int]  # original (M, N) before padding
    # prescale: A was factored as (A/scale) = Q·R_stored, so
    # R_true = scale · R_stored; 1.0 when prescaling is off.
    scale: object = 1.0


class HRFactors(NamedTuple):
    """Factors of the hr square path (``drivers/square_hr.py``): per-panel
    whole-panel compact-WY pairs (Y_k, T_k) and the assembled R (padded
    K × N_pad).

    ``health`` (0-d tensor, None under hr_guard="off") is the max over
    panels of the CholeskyQR round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max:
    ≲ 1e-3 is deep inside the hr contract; above QRConfig.hr_guard_tau (or
    NaN) a panel broke the cond²·eps limit."""

    r: torch.Tensor
    panels: Tuple  # ((Y_0, T_0), (Y_1, T_1), ...), Y_k: (M_pad − k·nb, nb)
    nb: int
    shape: Tuple[int, int]  # original (M, N)
    scale: object = 1.0  # see QRFactors.scale
    health: object = None


def _cfg(config: Optional[QRConfig]) -> QRConfig:
    return config if config is not None else QRConfig()


def _check_matrix(a, who: str) -> None:
    """ValueError for non-2-D inputs and zero-size dimensions (the
    reference's behaviour; numpy and torch.linalg.qr would return empty
    factors instead)."""
    shape = tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))
    if len(shape) != 2:
        hint = " — for a stack of matrices use tileqr_torch.qr_batched" if len(shape) == 3 else ""
        raise ValueError(f"{who} expects a 2-D matrix, got shape {shape}{hint}")
    if shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"{who}: zero-size dimension in input shape {shape}")


def _upload(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)``. A copy from the host onto the
    card goes through pageable memory and blocks the host until the stream
    has run: the span ``sync.upload``."""
    if torch.device(device).type == "cuda" and not (isinstance(x, torch.Tensor) and x.is_cuda):
        with span("tileqr_torch.sync.upload"):
            return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device``
    ("cuda" when None), which must exist."""
    if isinstance(a, torch.Tensor):
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != a.device.type or
                                 want.index not in (None, a.device.index)):
            raise ValueError(
                f"input tensor is on {a.device}, device={device!r} was asked for: "
                "move the tensor, or drop device="
            )
        return a.to(dtype=dtype)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tileqr_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' (or a CPU tensor) to run the plain "
            "CPU versions"
        )
    return _upload(np.asarray(a), dtype, dev)


def _private_tiles(a: torch.Tensor, nb: int) -> torch.Tensor:
    """A padded to nb multiples in a buffer of its own: the hh driver works
    in place, never on the caller's storage."""
    return pad_to_tiles(a, nb)[0].clone(memory_format=torch.contiguous_format)


@entry("tileqr_torch.qr_factor")
def qr_factor(a, config: Optional[QRConfig] = None, device=None):
    """Factor A → QRFactors (hh) or HRFactors (hr), with no Q/R assembly."""
    with span("tileqr_torch.prep"):
        _check_matrix(a, "qr_factor")
        cfg = _cfg(config)
        passes_of(cfg.precision)
        a = _to_device(a, cfg.dtype, device)
        m, n = a.shape
        scale = 1.0
        if cfg.prescale:
            # exact power-of-2 scaling: QR(A/s) has identical reflectors/τ and
            # R_true = s · R_stored; true division, not multiply-by-reciprocal
            # (1/2^127 is subnormal and would flush to zero where denormals
            # are off)
            scale = pow2_at_least(a.abs().max())
            a = a / scale
        hr = cfg.square_method == "hr"
        ap = pad_for_hr(a, cfg.nb)[0] if hr else _private_tiles(a, cfg.nb)
    if hr:
        stats = cfg.hr_guard != "off"
        r, panels, health = qr_hr(ap, cfg.nb, stats=stats, precision=cfg.precision)
        f = HRFactors(r, panels, cfg.nb, (m, n), scale, health)
        if not guard_falls_back(health, cfg, "qr_factor/hr"):
            return f
        # fall through to the hh path: `a` is already prescaled and `scale`
        # already captured, so the fallback reuses both
        with span("tileqr_torch.prep"):
            ap = _private_tiles(a, cfg.nb)
    packed, r_diag, t_g, panels = qr_tiled(ap, cfg.nb, ib=cfg.ib, chunk=cfg.chunk,
                                           precision=cfg.precision)
    return QRFactors(packed, r_diag, t_g, panels, cfg.nb, cfg.chunk, (m, n), scale)


@entry("tileqr_torch.apply_q")
def apply_q(f, c, trans: bool = False, config: Optional[QRConfig] = None) -> torch.Tensor:
    """C ← Q C (or Qᵀ C). c: (M, P) in the ORIGINAL row dimension (for
    ``TSQRFactors``, at most the factored rows)."""
    precision = _cfg(config).precision
    passes_of(precision)
    like = f.r if isinstance(f, (TSQRFactors, HRFactors)) else f.packed
    c = _upload(c, like.dtype, like.device)
    if isinstance(f, TSQRFactors):
        return tsqr_apply_q(f, c, trans=trans, precision=precision)
    if isinstance(f, HRFactors):
        mp = f.panels[0][0].shape[0]
        mc, p = c.shape
        if mc != f.shape[0]:
            raise ValueError(f"c rows {mc} != M {f.shape[0]}")
        cp = c.new_zeros((mp, p))
        cp[:mc] = c
        return apply_q_hr(f.panels, cp, f.nb, trans=trans, precision=precision)[:mc]
    mp = f.packed.shape[0]
    mc, p = c.shape
    if mc != f.shape[0]:
        raise ValueError(f"c rows {mc} != M {f.shape[0]}")
    pp = round_up(max(p, 1), f.nb)
    cp = c.new_zeros((mp, pp))
    cp[:mc, :p] = c
    out = apply_q_tiled(f.panels, f.t_geqrt, cp, f.nb, chunk=f.chunk, trans=trans,
                        precision=precision)
    return out[:mc, :p]


@entry("tileqr_torch.orgqr")
def orgqr(f, ncols: Optional[int] = None,
          config: Optional[QRConfig] = None) -> torch.Tensor:
    """Form Q explicitly: M×ncols (default: reduced, ncols = min(M, N)),
    with the xORGQR growing window (panel k skips columns left of it).
    ``TSQRFactors`` give the reduced Q of the factored (padded) matrix,
    ``f.shape``, and only that: ncols other than its n raises."""
    precision = _cfg(config).precision
    passes_of(precision)
    m, n = f.shape
    if isinstance(f, TSQRFactors):
        if ncols not in (None, n):
            raise ValueError(f"the TSQR tree forms the reduced Q only: ncols={ncols} != n={n}")
        return tsqr_form_q(f, precision)
    k = min(m, n) if ncols is None else ncols
    if isinstance(f, HRFactors):
        mp = f.panels[0][0].shape[0]
        return orgqr_hr(f.panels, mp, f.nb, max(k, 1), precision)[:m, :k]
    mp = f.packed.shape[0]
    pp = round_up(max(k, 1), f.nb)
    eye_p = torch.eye(mp, pp, dtype=f.packed.dtype, device=f.packed.device)
    out = apply_q_tiled(f.panels, f.t_geqrt, eye_p, f.nb, chunk=f.chunk,
                        trans=False, triangular=True, precision=precision)
    return out[:m, :k]


def _r_of(f) -> torch.Tensor:
    """R with the prescale folded back in: (K, N_pad) for hr, padded for hh."""
    with span("tileqr_torch.assemble_r"):
        if isinstance(f, HRFactors):
            return f.r * f.scale
        return assemble_r(f.packed, f.r_diag, f.nb) * f.scale


@entry("tileqr_torch.qr")
def qr(a, mode: str = "reduced", config: Optional[QRConfig] = None, device=None):
    """Tiled blocked QR. mode: "reduced" → (Q (M,K), R (K,N)); "complete" →
    (Q (M,M), R (M,N)); "r" → R (K,N) only. K = min(M, N)."""
    _check_matrix(a, "qr")
    if mode not in ("reduced", "complete", "r"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = _cfg(config)
    f = qr_factor(a, cfg, device=device)
    m, n = f.shape
    k = min(m, n)
    r_full = _r_of(f)
    if r_full.shape[0] < m:  # hr R has K rows; complete mode on tall input needs M
        r_full = torch.cat([r_full, r_full.new_zeros((m - r_full.shape[0], r_full.shape[1]))])
    if mode == "r":
        return r_full[:k, :n]
    if mode == "reduced":
        return orgqr(f, k, cfg), r_full[:k, :n]
    return orgqr(f, m, cfg), r_full[:m, :n]


@entry("tileqr_torch.lstsq")
def lstsq(a, b, config: Optional[QRConfig] = None, device=None) -> torch.Tensor:
    """Least-squares solve min ‖Ax − b‖₂ via QR (M >= N, full rank).

    b: (M,) or (M, P). Returns x: (N,) or (N, P): Qᵀb through the
    reflectors, then a back-solve on R."""
    _check_matrix(a, "lstsq")
    cfg = _cfg(config)
    a = _to_device(a, cfg.dtype, device)
    b_in = _upload(b, cfg.dtype, a.device)
    if b_in.dim() not in (1, 2):
        raise ValueError(f"lstsq: b must be (M,) or (M, P), got shape {tuple(b_in.shape)}")
    vec = b_in.dim() == 1
    bmat = b_in[:, None] if vec else b_in
    m, n = a.shape
    if m < n:
        raise ValueError("lstsq requires M >= N")
    f = qr_factor(a, cfg)
    qtb = apply_q(f, bmat, trans=True, config=cfg)[:n]
    r = _r_of(f)[:n, :n]
    x = torch.linalg.solve_triangular(r, qtb, upper=True)
    return x[:, 0] if vec else x


@entry("tileqr_torch.tsqr")
def tsqr(a, mode: str = "r", config: Optional[QRConfig] = None, strategy: str = "auto",
         device=None):
    """Tall-skinny QR of A (M, n), M >= n, n <= nb.

    mode "r" → R (n, n); "reduced" → (Q (M, n), R); "factor" →
    ``TSQRFactors`` (tree) or ``HRFactors`` (cholqr2), for ``apply_q`` and
    ``orgqr``.

    strategy:
      "tree": leaves of ``auto_leaf_rows`` rows, each factored by the
        batched GEQRT kernel in one launch, then wide-arity combines of the
        stacked R factors by the same kernel (``drivers/tsqr.py``).
      "chain": the square driver (``qr``) on the one wide panel; no
        "factor" mode.
      "cholqr2": CholeskyQR2 (``drivers/cholqr.py``, B = 1): one gram, the
        POTRF kernel, matmuls. Needs cond(A) ≲ 1e3 in fp32; its guard falls
        back to the tree. mode="factor" returns whole-panel compact-WY
        ``HRFactors`` by modified-LU reconstruction (``square_hr.hr_panel``
        with nb = the padded width).
      "auto": mode "factor" → "cholqr2" under hr_guard="fallback" (torch
        runs eagerly, so the guard can always act; the reference's
        trace-state test has no counterpart), else "tree". Modes "r" and
        "reduced" → "tree" on every device. The reference takes "chain" on a
        compiled TPU from TPU timings; on the H100 the chain is the hh square
        path, whose panel kernel K2 runs on ONE SM per launch, and a single
        512-wide panel would push its 2047 sub-diagonal tiles through it in
        series, while the tree spreads 512 leaves over the 132 SMs. On the
        CPU "tree" is also what the reference's interpret-mode rule picks.
    """
    with span("tileqr_torch.prep"):
        _check_matrix(a, "tsqr")
        if strategy not in ("auto", "tree", "chain", "cholqr2"):
            raise ValueError(f"unknown strategy {strategy!r} (auto/tree/chain/cholqr2)")
        if mode not in ("r", "reduced", "factor"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = _cfg(config)
        passes_of(cfg.precision)
        a = _to_device(a, cfg.dtype, device)
        m, n = a.shape
        if m < n:
            raise ValueError(f"tsqr requires M >= n, got shape {(m, n)}")
        if strategy == "auto":
            strategy = "cholqr2" if mode == "factor" and cfg.hr_guard == "fallback" else "tree"
        if strategy != "cholqr2" and n > cfg.nb:
            raise ValueError(f"tsqr requires n={n} <= nb={cfg.nb}")
        if strategy == "chain" and mode == "factor":
            raise ValueError(
                'tsqr(strategy="chain") has no "factor" mode; use strategy="tree" '
                "(TSQRFactors) or qr_factor (square factors)"
            )
        stats = cfg.hr_guard != "off"
        if strategy == "cholqr2" and mode == "factor":
            nbp = round_up(max(n, 8), 8)
            ap, _ = pad_for_hr(a, nbp)
        elif strategy == "tree":
            np_ = round_up(n, 8)
            lr = auto_leaf_rows(round_up(m, 8), np_)
            ap = torch.nn.functional.pad(a, (0, np_ - n, 0, round_up(m, lr) - m))
    if strategy == "cholqr2":
        if mode == "factor":
            with _highest():
                out = hr_panel(ap, stats=stats)
            health = out[3] if stats else None
            if guard_falls_back(health, cfg, "tsqr(factor, strategy='cholqr2')"):
                return tsqr(a, "factor", cfg, "tree")
            return HRFactors(out[2], ((out[0], out[1]),), nbp, (m, n), 1.0, health)
        out = cholqr2_batched(a[None], mode=mode, stats=stats, precision=cfg.precision)
        health = out[-1] if stats else None
        if guard_falls_back(health, cfg, "tsqr(strategy='cholqr2')"):
            return tsqr(a, mode, cfg, "tree")
        if mode == "r":
            return (out[0] if stats else out)[0]
        return out[0][0], out[1][0]
    if strategy == "chain":
        return qr(a, mode=mode, config=cfg)
    f = tsqr_factor(ap, cfg.nb, ib=cfg.ib, leaf_rows=lr)
    if mode == "factor":
        return f
    r = f.r[:n, :n]
    if mode == "r":
        return r
    return tsqr_form_q(f, cfg.precision)[:m, :n], r


@entry("tileqr_torch.qr_batched")
def qr_batched(a, mode: str = "reduced", config: Optional[QRConfig] = None, device=None):
    """Batched QR of a (B, m, n) stack, m >= n: mode "reduced" → (Q (B, m, n),
    R (B, n, n)); "r" → R. ``QRConfig.batched_method`` picks the route: "hh"
    (the batched GEQRT kernel at ``batched_ib``, every batch size) or
    "cholqr2" (rows padded only; one bad member trips the guard and sends
    the whole batch to the hh route under hr_guard="fallback")."""
    with span("tileqr_torch.prep"):
        shape = tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))
        if len(shape) != 3 or 0 in shape:
            raise ValueError(
                f"qr_batched expects a (B, m, n) stack with no zero-size dimension, "
                f"got shape {shape}"
            )
        if mode not in ("reduced", "r"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = _cfg(config)
        passes_of(cfg.precision)
        if cfg.batched_method not in ("hh", "cholqr2"):
            raise ValueError(f"unknown batched_method {cfg.batched_method!r} (hh/cholqr2)")
        a = _to_device(a, cfg.dtype, device)
        b, m, n = a.shape
        if m < n:
            raise ValueError(f"qr_batched requires m >= n, got ({m}, {n})")
        mp, np_ = round_up(m, 8), round_up(n, 8)
        cholqr2 = cfg.batched_method == "cholqr2"
        # column padding would make the gram singular: rows only for cholqr2
        ap = torch.nn.functional.pad(a, (0, 0 if cholqr2 else np_ - n, 0, mp - m))
    if cholqr2:
        stats = cfg.hr_guard != "off"
        out = cholqr2_batched(ap, mode=mode, stats=stats, precision=cfg.precision)
        health = out[-1] if stats else None
        if not guard_falls_back(health, cfg, "qr_batched/cholqr2"):
            if mode == "r":
                return out[0] if stats else out
            return out[0][:, :m, :], out[1]
        with span("tileqr_torch.prep"):
            ap = torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
    out = _qr_batched(ap, mode=mode, ib=cfg.batched_ib, precision=cfg.precision)
    if mode == "r":
        return out[:, :n, :n]
    q, r = out
    return q[:, :m, :n], r[:, :n, :n]


def qr_sharded(a, mesh: Optional[Mesh] = None, config: Optional[QRConfig] = None,
               mode: str = "r", device=None):
    """2D block-cyclic sharded QR (tileqr's BASELINE config 5), called by
    every rank of the mesh with the same global A (M, N).

    mode "r" → R (M, N) on every rank; "factor" → this rank's
    ``ShardedFactors`` (or ``ShardedHRFactors``), for
    ``assemble_r_sharded`` and ``apply_q_sharded``. mesh: a
    ``tileqr_torch.dist.mesh.Mesh``; None builds one of
    ``config.mesh_shape`` over the default process group.
    ``square_method="hr"`` runs the CholeskyQR2 sharded driver
    (``drivers/sharded_hr.py``); its breakdown guard, checked on the host
    (every rank holds the same health), falls back to the Householder one
    under ``hr_guard="fallback"``. The Householder couple height follows
    tileqr's driver rule (``QRConfig.driver``): 1 where tileqr takes its
    static driver, ``config.chunk`` (clamped to the local tile rows) where
    it takes the dynamic one.
    """
    shape = tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))
    if len(shape) != 2 or 0 in shape:
        raise ValueError(
            f"qr_sharded expects a 2-D matrix with no zero-size dimension, got shape {shape}"
        )
    if mode not in ("r", "factor"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = _cfg(config)
    passes_of(cfg.precision)
    if mesh is None:
        mesh = Mesh(*cfg.mesh_shape)
    a = _to_device(a, cfg.dtype, device if isinstance(a, torch.Tensor) else rank_device(device))
    if cfg.square_method == "hr":
        fh = _shr.qr_sharded_factor_hr(a, mesh, cfg.nb, cfg.precision)
        health = fh.health if cfg.hr_guard != "off" else None
        if not guard_falls_back(health, cfg, "qr_sharded/hr"):
            return fh if mode == "factor" else _sh.assemble_r_sharded(fh, mesh)
    chunk = 1 if cfg.resolve_driver(*shape) == "static" else cfg.chunk
    f = _sh.qr_sharded_factor(a, mesh, cfg.nb, cfg.ib, chunk, cfg.precision)
    return f if mode == "factor" else _sh.assemble_r_sharded(f, mesh)


def _mesh_of(f, mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else Mesh(*f.grid[2:])


def assemble_r_sharded(f, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """R (M, N) from the sharded factors (``ShardedFactors`` or
    ``ShardedHRFactors``), on every rank (a collective). mesh: the
    factor's; None builds one of the factor's shape."""
    return _sh.assemble_r_sharded(f, _mesh_of(f, mesh))


def apply_q_sharded(f, c, mesh: Optional[Mesh] = None, trans: bool = True,
                    config: Optional[QRConfig] = None) -> torch.Tensor:
    """C ← Qᵀ·C (trans, the default, as tileqr's) or Q·C with the sharded
    factors, on every rank (a collective): C (M, P), the same on every
    rank, goes to the factors' device. Both factor records are taken:
    tileqr's own ``apply_q_sharded`` refuses ``ShardedHRFactors``
    (AttributeError on ``panels``), the port routes them to
    ``apply_q_sharded_hr``."""
    precision = _cfg(config).precision
    passes_of(precision)
    c = torch.as_tensor(c, dtype=f.local.dtype, device=f.local.device)
    apply = _shr.apply_q_sharded_hr if isinstance(f, ShardedHRFactors) else _sh.apply_q_sharded
    return apply(f, c, _mesh_of(f, mesh), trans=trans, precision=precision)

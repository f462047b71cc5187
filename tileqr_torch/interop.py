"""Moving factors between the JAX package and the port.

QR has no weights: its state is the factors. These helpers convert the
static driver's ``QRFactors`` (``packed``, ``r_diag``, ``t_geqrt``,
``panels``, ``nb``, ``chunk``, ``shape``, ``scale``), the hr path's
``HRFactors`` (``r``, ``panels`` as (Y_k, T_k), ``nb``, ``shape``,
``scale``, ``health``) and the TSQR tree's ``TSQRFactors``
(``packed_leaves``, ``t_leaves``, ``levels`` as (pk, tl, count, arity),
``r``, ``leaf_rows``, ``shape``, ``plan``) between numpy arrays and the
port's torch tensors, so that either package can consume factors the
other made; and the dynamic sharded driver's ``ShardedDynFactors``, whose
per-device buffers carry leading (pr, pc) axes, to and from the port's
per-rank ``ShardedFactors``. Neither direction imports
jax: the JAX side is reached through ``numpy.asarray`` on its arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from tileqr_torch.api import HRFactors, QRFactors, ShardedFactors, TSQRFactors

# ShardedFactors' per-rank buffers: (pr, pc, ...)-stacked in ShardedDynFactors
_SHARDED_BUFFERS = ("local", "v_heads", "tg_all", "t2_heads", "v_chunks", "t2_chunks",
                    "tree_v2", "tree_t2")


def _scalar_from(x, t):
    return x if x is None or isinstance(x, float) else t(x)


def _scalar_to(x):
    return x if x is None or isinstance(x, float) else np.asarray(x.detach().cpu())


def factors_from_numpy(f: Any, device=None, dtype=None) -> QRFactors:
    """A mapping or NamedTuple with the QRFactors fields (arrays as numpy
    or anything ``numpy.asarray`` takes) → the port's QRFactors on
    ``device``."""
    d = f._asdict() if hasattr(f, "_asdict") else dict(f)

    def t(x):
        return torch.as_tensor(np.array(x), device=device, dtype=dtype)

    scale = _scalar_from(d.get("scale", 1.0), t)
    return QRFactors(
        t(d["packed"]), t(d["r_diag"]), t(d["t_geqrt"]),
        tuple(tuple(t(x) for x in p) for p in d["panels"]),
        int(d["nb"]), int(d["chunk"]), tuple(int(s) for s in d["shape"]), scale,
    )


def factors_to_numpy(f: QRFactors) -> Dict[str, Any]:
    """The port's QRFactors → a dict of numpy arrays under the QRFactors
    field names (``tileqr.api.QRFactors(**d)`` rebuilds the JAX record)."""

    def n(x):
        return x.detach().cpu().numpy()

    scale = _scalar_to(f.scale)
    out = dict(zip(QRFactors._fields, (
        n(f.packed), n(f.r_diag), n(f.t_geqrt),
        tuple(tuple(n(x) for x in p) for p in f.panels),
        f.nb, f.chunk, tuple(f.shape), scale,
    )))
    return out


def hr_factors_from_numpy(f: Any, device=None, dtype=None) -> HRFactors:
    """A mapping or NamedTuple with the HRFactors fields → the port's
    HRFactors on ``device``."""
    d = f._asdict() if hasattr(f, "_asdict") else dict(f)

    def t(x):
        return torch.as_tensor(np.array(x), device=device, dtype=dtype)

    return HRFactors(
        t(d["r"]), tuple((t(y), t(tk)) for y, tk in d["panels"]), int(d["nb"]),
        tuple(int(s) for s in d["shape"]), _scalar_from(d.get("scale", 1.0), t),
        _scalar_from(d.get("health"), t),
    )


def hr_factors_to_numpy(f: HRFactors) -> Dict[str, Any]:
    """The port's HRFactors → a dict of numpy arrays under the HRFactors
    field names (``tileqr.api.HRFactors(**d)`` rebuilds the JAX record)."""

    def n(x):
        return x.detach().cpu().numpy()

    return dict(zip(HRFactors._fields, (
        n(f.r), tuple((n(y), n(t)) for y, t in f.panels), f.nb, tuple(f.shape),
        _scalar_to(f.scale), _scalar_to(f.health),
    )))


def _plan(plan) -> tuple:
    return tuple((int(c), int(a), tuple(int(i) for i in flat), tuple(int(i) for i in rem))
                 for c, a, flat, rem in plan)


def tsqr_factors_from_numpy(f: Any, device=None, dtype=None) -> TSQRFactors:
    """A mapping or NamedTuple with the TSQRFactors fields → the port's
    TSQRFactors on ``device``."""
    d = f._asdict() if hasattr(f, "_asdict") else dict(f)

    def t(x):
        return torch.as_tensor(np.array(x), device=device, dtype=dtype)

    return TSQRFactors(
        t(d["packed_leaves"]), t(d["t_leaves"]),
        tuple((t(pk), t(tl), int(c), int(a)) for pk, tl, c, a in d["levels"]),
        t(d["r"]), int(d["leaf_rows"]), tuple(int(s) for s in d["shape"]), _plan(d["plan"]),
    )


def tsqr_factors_to_numpy(f: TSQRFactors) -> Dict[str, Any]:
    """The port's TSQRFactors → a dict of numpy arrays under the TSQRFactors
    field names (``tileqr.drivers.tsqr.TSQRFactors(**d)`` rebuilds the JAX
    record)."""

    def n(x):
        return x.detach().cpu().numpy()

    return dict(zip(TSQRFactors._fields, (
        n(f.packed_leaves), n(f.t_leaves),
        tuple((n(pk), n(tl), int(c), int(a)) for pk, tl, c, a in f.levels),
        n(f.r), f.leaf_rows, tuple(f.shape), _plan(f.plan),
    )))


def sharded_factors_from_numpy(f: Any, coords: Tuple[int, int], device=None,
                               dtype=None) -> ShardedFactors:
    """tileqr's ``ShardedDynFactors`` (a mapping or NamedTuple, arrays as
    numpy or anything ``numpy.asarray`` takes) → rank ``coords`` = (r, c)'s
    ``ShardedFactors`` on ``device``: its slice of every sharded buffer and
    the replicated ``r_diag``."""
    d = f._asdict() if hasattr(f, "_asdict") else dict(f)
    r, c = coords

    def t(x):
        return torch.as_tensor(np.array(x), device=device, dtype=dtype)

    bufs = {k: t(np.asarray(d[k])[r, c]) for k in _SHARDED_BUFFERS}
    return ShardedFactors(
        r_diag=t(d["r_diag"]), nb=int(d["nb"]), chunk=int(d["chunk"]),
        shape=tuple(int(s) for s in d["shape"]), grid=tuple(int(g) for g in d["grid"]),
        coords=(int(r), int(c)), **bufs,
    )


def sharded_factors_to_numpy(fs: Sequence[ShardedFactors]) -> Dict[str, Any]:
    """Every rank's ``ShardedFactors``, in rank order → a dict of numpy
    arrays under the ``ShardedDynFactors`` field names, the per-rank
    buffers stacked on leading (pr, pc) axes
    (``tileqr.drivers.sharded_dyn.ShardedDynFactors(**d)`` rebuilds the JAX
    record)."""
    f0 = fs[0]
    pr, pc = f0.grid[2:]
    if [tuple(f.coords) for f in fs] != [(r, c) for r in range(pr) for c in range(pc)]:
        raise ValueError("sharded_factors_to_numpy takes every rank's factors in rank order")

    def n(x):
        return x.detach().cpu().numpy()

    out = {k: np.stack([n(getattr(f, k)) for f in fs]).reshape(
        (pr, pc) + tuple(getattr(f0, k).shape)) for k in _SHARDED_BUFFERS}
    out.update(r_diag=n(f0.r_diag), nb=f0.nb, chunk=f0.chunk, shape=tuple(f0.shape),
               grid=tuple(f0.grid))
    return out

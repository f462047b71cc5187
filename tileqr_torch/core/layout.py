"""Tile-layout math: padding to tile multiples and tile counts.

Copies of ``tileqr/core/layout.py``'s helpers with torch padding (the JAX
module is not imported: doing so would import jax), and the exact power of
two that prescaling and the hr column padding both use.
"""

from __future__ import annotations

from typing import Tuple

import math

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_to_tiles(a: torch.Tensor, nb: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad a 2-D matrix so both dims are multiples of nb.

    Returns the padded matrix and the original (M, N). Zero-padding is exact
    for QR: padded columns/rows produce tau = 0 reflectors and zero R
    blocks. When no padding is needed the input itself is returned.
    """
    m, n = a.shape
    mp, np_ = round_up(m, nb), round_up(n, nb)
    if (mp, np_) != (m, n):
        a = torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
    return a, (m, n)


def tile_counts(shape: Tuple[int, int], nb: int) -> Tuple[int, int]:
    m, n = shape
    if m % nb or n % nb:
        raise ValueError(f"shape {shape} not a multiple of nb={nb}")
    return m // nb, n // nb


def pow2_at_least(amax: torch.Tensor) -> torch.Tensor:
    """2**ceil(log2(amax)), clamped to the dtype's largest power of two, and
    1 where amax is 0: the scale of ``tileqr``'s prescale and α of its
    ``pad_for_hr``. Built from the exponent bits, so it is exact where
    ``exp2`` may round (``tileqr`` uses ``jnp.exp2``, which does on
    XLA:CPU)."""
    fi = torch.finfo(amax.dtype)
    e = torch.ceil(torch.log2(torch.clamp(amax, min=fi.tiny)))
    e = torch.clamp(e, max=float(math.frexp(fi.max)[1] - 1))
    if amax.dtype == torch.float64:
        p = ((e.to(torch.int64) + 1023) << 52).view(torch.float64)
    elif amax.dtype == torch.float32:
        p = ((e.to(torch.int32) + 127) << 23).view(torch.float32)
    else:
        p = torch.exp2(e)
    return torch.where(amax > 0, p, torch.ones_like(p))

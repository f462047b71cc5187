"""Batched QR of (B, m, n) stacks of small matrices (counterpart of
``tileqr/drivers/batched.py:qr_batched``).

One launch of the batched GEQRT kernel (``kernels/geqrt.py:geqrt_batched``,
one thread block per matrix) factors the whole stack at ``ib``; Q comes
from the compact-WY identity Q = E − V·T·V₁ᵀ (E the first n columns of I)
by two batched ``torch.matmul`` with TF32 off.

Its products are fp32 in every precision mode; "b3"/"b4" raise, as the
reference's XLA products (and its GEQRT kernel's) do
(``common.refuse_xla_site``).

The reference picks a group size that divides B (``select_group``) and
falls back to a batch-vectorized XLA GEQRT (``geqrt_batched_vec``) for odd
B, because its TPU grid step held G matrices. The CUDA grid is the batch
itself, so every B takes the one kernel.
"""

from __future__ import annotations

import torch

from tileqr_torch.core.trace import span
from tileqr_torch.drivers.cholqr import _highest
from tileqr_torch.kernels.common import refuse_xla_site, unit_lower
from tileqr_torch.kernels.geqrt import geqrt_batched


def qr_batched(a: torch.Tensor, mode: str = "reduced", ib: int = 32,
               precision: str = "highest"):
    """Batched QR of a (B, m, n), m >= n. mode "reduced" → (Q (B, m, n),
    R (B, n, n)); "r" → R. ib: the inner block width
    (``QRConfig.batched_ib``)."""
    refuse_xla_site(precision, "qr_batched")
    b, m, n = a.shape
    if n > m:
        raise ValueError("qr_batched requires m >= n")
    with span("tileqr_torch.batched.geqrt"):
        packed, t = geqrt_batched(a, ib)
        r = torch.triu(packed[:, :n, :])
    if mode == "r":
        return r
    with span("tileqr_torch.batched.form_q"):
        v = unit_lower(packed)
        eye = torch.eye(m, n, dtype=a.dtype, device=a.device)
        with _highest():
            q = eye - v @ (t @ v[:, :n, :].transpose(1, 2))
    return q, r

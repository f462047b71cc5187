"""TSQRT: QR of the couple [R; B], R (nb, nb) upper triangular, B (m, nb).

Counterpart of ``tileqr/kernels/tsqrt.py:tsqrt`` (B15), the single-couple
entry of the unit tests. It is K2 (``kernels/chain.py:panel_chain``,
``csrc/chain.cu``) with one couple of B's rows: on a CUDA tensor the kernel,
on a CPU tensor ``panel_chain_plain``. The column loop runs at tileqr's
tsqrt width, ``ib`` = 128 by default.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tileqr_torch.kernels.chain import panel_chain
from tileqr_torch.kernels.ttqrt import TREE_IB


def tsqrt(r: torch.Tensor, b: torch.Tensor,
          ib: int = TREE_IB) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R (nb, nb) upper triangular, B (m, nb), m a multiple of nb) →
    (R', V2 (m, nb), T2 (nb, nb)). Neither input is written."""
    nb = r.shape[0]
    m = b.shape[0]
    if tuple(r.shape) != (nb, nb) or b.dim() != 2 or b.shape[1] != nb or m % nb or m == 0:
        raise ValueError(f"tsqrt: R {tuple(r.shape)} and B {tuple(b.shape)}")
    r_out, v_chunks, t2 = panel_chain(b.contiguous(), r.contiguous(), 0, nb, 0, 1, m, ib)
    return r_out, v_chunks[0], t2[0]

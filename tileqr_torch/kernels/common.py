"""Shared helpers of the plain kernel versions: masks and matmuls.

Plain torch counterparts of ``tileqr/kernels/common.py`` for precision
"highest" only. Products accumulate in the operand dtype: float32, or
float64 on the CPU. The CUDA kernels never call these. Each takes a matrix
or a stack of matrices (leading batch dimensions), as ``vmap`` over the
JAX helper would.
"""

from __future__ import annotations

import torch


def unit_lower(packed: torch.Tensor) -> torch.Tensor:
    """V = strictly-lower(packed) + I (LAPACK GEQRT packed convention)."""
    m, n = packed.shape[-2:]
    v = torch.tril(packed, -1)
    return v + torch.eye(m, n, dtype=packed.dtype, device=packed.device)


def triu(a: torch.Tensor) -> torch.Tensor:
    return torch.triu(a)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ @ b."""
    return a.transpose(-2, -1) @ b

"""Shared helpers of the plain kernel versions: masks, matmuls and the
precision modes.

Plain torch counterparts of ``tileqr/kernels/common.py``. Products
accumulate in the operand dtype: float32, or float64 on the CPU. Each takes
a matrix or a stack of matrices (leading batch dimensions), as ``vmap``
over the JAX helper would.

The precision modes (``QRConfig.precision``; the table is in
``core/config.py``): "highest" is the plain fp32 product; "b3", "b4",
"high" and "default" split each fp32 operand into bf16 halves hi + lo and
take ``PASSES[mode]`` bf16 products, each exact in fp32, accumulated in
fp32 (``dot_bx``). Any mode on float64 operands is the exact product, as
``tileqr``'s ``dot``/``dot_t`` fall back to HIGHEST there. The CUDA kernels
compute the same products on the tensor cores (``csrc/bx_mma.cuh``'s split on
``csrc/tile_gemm.cuh``'s wgmma routine) and are
held to these by tolerance.
"""

from __future__ import annotations

import torch

# bf16 passes of the split product per mode ("highest" takes none)
PASSES = {"b3": 3, "b4": 4, "high": 3, "default": 1}
PRECISIONS = ("highest",) + tuple(PASSES)
# the kernel instantiation that computes each pass count
_MODE_OF_PASSES = {0: "highest", 1: "default", 3: "b3", 4: "b4"}


def passes_of(precision: str) -> int:
    """bf16 passes of the mode's product: 0 for "highest"; ValueError for
    a name that is not a mode."""
    if precision == "highest":
        return 0
    if precision not in PASSES:
        raise ValueError(f"precision={precision!r} must be one of {PRECISIONS}")
    return PASSES[precision]


def counter_key(name: str, precision: str) -> str:
    """The launch/plain-call counter of kernel ``name`` in this mode:
    ``name`` for "highest", ``name[mode]`` for the instantiation that runs
    it otherwise ("high" runs b3's)."""
    mode = _MODE_OF_PASSES[passes_of(precision)]
    return name if mode == "highest" else f"{name}[{mode}]"


def refuse_xla_site(precision: str, where: str) -> None:
    """ValueError for "b3"/"b4" at a site where ``tileqr`` hands the mode to
    an XLA product (a ``jnp.dot``/``einsum`` outside its kernels), which
    takes only its own precisions and so raises there: the port raises
    where the reference does. "high" and "default" run these products in
    fp32, as "highest" (ROADMAP.md queue C)."""
    passes_of(precision)
    if precision in ("b3", "b4"):
        raise ValueError(
            f"precision={precision!r} is not supported by {where}: the reference "
            "computes it with an XLA product, which takes 'highest', 'high' or "
            "'default' only"
        )


def split_bf16(a: torch.Tensor):
    """a ≈ hi + lo, both bf16 values held in a's dtype: hi = a rounded to
    nearest, lo = the exact residual a − hi rounded to nearest
    (``tileqr/kernels/common.py:_split_bf16``, the in-kernel split)."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, (a - hi).to(torch.bfloat16).to(a.dtype)


def split_bf16_trunc(a: torch.Tensor):
    """The truncating split of ``tileqr``'s XLA-level emulation
    (``_split_bf16_xla``): hi = a with its low 16 bits masked off, lo = the
    residual rounded to nearest. The hr driver's plain-torch products use
    it where ``tileqr``'s do, so that the two agree to float32 rounding
    (the two splits differ by about 1e-5)."""
    hi = (a.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, (a - hi).to(torch.bfloat16).to(torch.float32)


def dot_bx(a: torch.Tensor, b: torch.Tensor, passes: int, split=split_bf16) -> torch.Tensor:
    """a @ b by ``passes`` bf16 products of the split halves (tileqr's
    ``_dot_bx`` order: hh, then hl + lh, then ll), fp32 accumulation; the
    plain product for passes 0 or a non-float32 dtype. The halves are
    multiplied upcast with TF32 off (the callers' matmul setting), so each
    bf16×bf16 product is exact, as on XLA."""
    if passes == 0 or a.dtype != torch.float32:
        return a @ b
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bh
    if passes == 1:
        return out
    out = out + (ah @ bl + al @ bh)
    if passes >= 4:
        out = out + al @ bl
    return out


def unit_lower(packed: torch.Tensor) -> torch.Tensor:
    """V = strictly-lower(packed) + I (LAPACK GEQRT packed convention)."""
    m, n = packed.shape[-2:]
    v = torch.tril(packed, -1)
    return v + torch.eye(m, n, dtype=packed.dtype, device=packed.device)


def triu(a: torch.Tensor) -> torch.Tensor:
    return torch.triu(a)


def dot(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """a @ b in the mode's product (round-to-nearest split, as in-kernel)."""
    return dot_bx(a, b, passes_of(precision))


def dot_t(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """aᵀ @ b."""
    return dot(a.transpose(-2, -1), b, precision)

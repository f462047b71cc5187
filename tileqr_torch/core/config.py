"""QR configuration for the PyTorch port.

Mirrors ``tileqr/core/config.py``: the same fields, defaults and
validation, so a configuration means the same thing in both packages.
``dtype`` is a ``torch.dtype``. ``interpret`` and ``donate`` are accepted
and ignored (they steer Pallas interpretation and XLA buffer donation,
which have no counterpart here). The port has one driver per path, which
takes integer offsets at launch time. ``driver`` selects nothing on the
square paths; on the sharded path ``resolve_driver`` picks the couple
height, because tileqr's two sharded drivers differ in algebra (see
``driver`` below).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch

from tileqr_torch.core.layout import round_up


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Configuration for tiled QR runs.

    Attributes:
      nb: tile size (square nb×nb tiles). 256 is the acceptance value.
      ib: inner blocking inside the panel kernels: ``ib`` Householder
        columns are produced with rank-1 updates, then the rest of the tile
        gets one block-reflector apply. Clamped to the largest divisor of
        nb not exceeding it.
      hr_guard, hr_guard_tau: the hr breakdown guard ("fallback" refactors
        on the hh path, "warn" keeps the hr factors, "off" runs no check)
        and its threshold on the panels' health.
      batched_ib: inner block width of ``qr_batched``'s GEQRT (hh route).
      batched_method: ``qr_batched``'s route, "hh" (batched GEQRT) or
        "cholqr2" (CholeskyQR2, guarded like hr).
      mesh_shape: (pr, pc), the process grid ``qr_sharded`` builds when
        it is given no mesh: pr·pc ranks of the default process group
        (``tileqr_torch.dist``); (1, 1) runs in-process with no group.
      square_method: "hh" (tiled Householder) or "hr" (CholeskyQR2 panels
        with Householder reconstruction, ``drivers/square_hr.py``).
      chunk: sub-diagonal couple height in tiles; reduced by the driver to
        the largest divisor of the row-tile count.
      dtype: compute dtype; float32 on the GPU (float64 runs only on the
        CPU plain versions).
      precision: the product of the update and apply kernels (K3/K4, B6,
        B7) and of the hr applies, mapped onto the H100 as follows
        (``kernels/common.py``, ``csrc/bx_mma.cuh``):

          "highest"       IEEE fp32 FMA on CUDA cores, never TF32.
          "b3" / "b4"     each fp32 operand split into bf16 hi + lo (round
                          to nearest), 3 (hh + (hl + lh)) or 4 (+ ll) bf16
                          tensor-core products, fp32 accumulation
                          (tileqr's _dot_bx).
          "default"       one bf16 product Ah·Bh, fp32 accumulation: the
                          TPU's DEFAULT on fp32 operands.
          "high"          the b3 algebra (XLA's HIGH on fp32 is bf16_3x).
          float64, any    the exact product, as tileqr's dot/dot_t.

        The panel kernels (K1, K2, B8, B9, the batched GEQRT) and the hr
        panel stay fp32 in every mode, as in tileqr. The hr apply sends
        every nb-aligned target in an emulated mode to B7; its plain-torch
        products on the other targets take tileqr's truncating split
        (``split_bf16_trunc``) in b3/b4, where tileqr's XLA-level ones do,
        and round to nearest in "high"/"default" (XLA's HIGH/DEFAULT). Where
        tileqr hands the mode to a plain XLA product (``tsqr`` forming Q,
        ``qr_batched``, CholeskyQR2), "b3" and "b4" raise ValueError as
        they do there, and "high"/"default" run fp32.
      interpret, donate: accepted and ignored.
      driver: "auto", "static" or "dynamic". The square paths ignore it
        (one driver each). ``qr_sharded`` follows tileqr's rule
        (``resolve_driver``): where tileqr takes its static sharded driver
        ("static", or "auto" with at most AUTO_STATIC_MAX_PANELS panels)
        the port's driver eliminates tile by tile (chunk 1, the static
        driver's algebra); otherwise in couples of ``chunk`` tiles, as
        tileqr's dynamic driver. The two give different, equally valid R.
      prescale: divide A by an exact power of 2 ≥ max|A| before factoring
        and fold the scale back into R (lifts the fp32 column-norm overflow
        limit of the unscaled Householder column loop).
    """

    nb: int = 256
    ib: int = 128
    batched_ib: int = 32
    batched_method: str = "hh"
    square_method: str = "hh"
    hr_guard: str = "fallback"
    hr_guard_tau: float = 0.05
    chunk: int = 4
    dtype: torch.dtype = torch.float32
    precision: str = "highest"
    interpret: Optional[bool] = None
    mesh_shape: Tuple[int, int] = (4, 2)
    driver: str = "auto"
    prescale: bool = False
    donate: bool = False

    # "auto" takes tileqr's static sharded driver up to this many panels
    AUTO_STATIC_MAX_PANELS: ClassVar[int] = 32

    def __post_init__(self):
        if self.nb % 8 != 0:
            raise ValueError(f"nb={self.nb} must be a multiple of 8")
        if self.ib < 1:
            raise ValueError(f"ib={self.ib} must be >= 1")
        if self.ib > self.nb:
            object.__setattr__(self, "ib", self.nb)
        if self.nb % self.ib != 0:
            ib = self.ib
            while self.nb % ib:
                ib -= 1
            object.__setattr__(self, "ib", ib)
        if self.driver not in ("auto", "static", "dynamic"):
            raise ValueError(f"driver={self.driver!r} must be auto|static|dynamic")
        if self.square_method not in ("hh", "hr"):
            raise ValueError(
                f"square_method={self.square_method!r} must be hh|hr"
            )
        if self.hr_guard not in ("fallback", "warn", "off"):
            raise ValueError(
                f"hr_guard={self.hr_guard!r} must be fallback|warn|off"
            )

    def resolve_driver(self, m: int, n: int) -> str:
        """tileqr's driver for an (m, n) problem ("auto" → the panel-count
        rule)."""
        if self.driver != "auto":
            return self.driver
        k_max = min(round_up(m, self.nb), round_up(n, self.nb)) // self.nb
        return "static" if k_max <= self.AUTO_STATIC_MAX_PANELS else "dynamic"

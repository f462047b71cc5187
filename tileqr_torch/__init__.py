"""tileqr_torch — ``tileqr`` ported to PyTorch with hand-written CUDA
kernels for the NVIDIA H100 (sm_90a).

Two square paths, as in ``tileqr.qr``:

- square_method="hh" (the default): the right-looking tiled Householder
  driver and its four panel and update kernels (``kernels/panel.py``,
  ``kernels/chain.py``);
- square_method="hr": CholeskyQR2 panels with Householder reconstruction
  (``drivers/square_hr.py``) and its POTRF, modified-LU and whole-panel
  apply kernels (``kernels/potrf.py``, ``kernels/modlu.py``,
  ``kernels/panel_apply.py``), with the breakdown guard falling back to hh.

Beside them, ``tsqr`` (tall-skinny: a tree of leaves and combines, chain or
CholeskyQR2) and ``qr_batched`` (stacks of small matrices), whose
Householder routes run one batched GEQRT kernel (``kernels/geqrt.py``); and
``qr_sharded`` (2D block-cyclic over a pr × pc process grid on
``torch.distributed``, ``dist/mesh.py``; the Householder sharded driver
``drivers/sharded.py`` with the TTQRT tree-combine kernel,
``kernels/ttqrt.py``, or, with square_method="hr", the CholeskyQR2 one
``drivers/sharded_hr.py`` with B7's halves ``panel_project`` and
``panel_sub``), whose factors ``assemble_r_sharded`` and
``apply_q_sharded`` consume. ``dist/launch.py`` spawns such a world.

CUDA sources are in ``csrc/``. CUDA tensors run the CUDA kernels; CPU
tensors run each kernel's plain torch version. Non-tensor inputs go to the
card unless ``device="cpu"`` is passed.

Public API
----------
- :func:`qr`, :func:`qr_factor`, :func:`apply_q`, :func:`orgqr`,
  :func:`lstsq`, :func:`tsqr`, :func:`qr_batched`
- :func:`qr_sharded`, :func:`assemble_r_sharded`, :func:`apply_q_sharded`
- :class:`QRConfig`, :class:`QRFactors`, :class:`HRFactors`,
  :class:`TSQRFactors`, :class:`ShardedFactors`, :class:`ShardedHRFactors`
- :func:`qr_check` — float64 acceptance metrics of a computed QR.
- :func:`release_graphs` — drop the CUDA graphs that the hr square path
  keeps of its last shape's panel loop (``drivers/square_hr.py``).
"""

from tileqr_torch.core.config import QRConfig
from tileqr_torch.api import (
    HRFactors,
    QRFactors,
    ShardedFactors,
    ShardedHRFactors,
    TSQRFactors,
    apply_q,
    apply_q_sharded,
    assemble_r_sharded,
    lstsq,
    orgqr,
    qr,
    qr_batched,
    qr_factor,
    qr_sharded,
    tsqr,
)
from tileqr_torch.drivers.square_hr import release_graphs
from tileqr_torch.utils.verify import qr_check

__all__ = [
    "HRFactors",
    "QRConfig",
    "QRFactors",
    "ShardedFactors",
    "ShardedHRFactors",
    "TSQRFactors",
    "apply_q",
    "apply_q_sharded",
    "assemble_r_sharded",
    "lstsq",
    "orgqr",
    "qr",
    "qr_batched",
    "qr_check",
    "qr_factor",
    "qr_sharded",
    "release_graphs",
    "tsqr",
]

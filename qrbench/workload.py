"""The one general generator: a cell's inputs, and its call from data.

Inputs: the configuration's ``shape`` and ``input``, a distribution by
name (``inputs/<distribution>.py``) with its parameters, made on the device
from ``--seed`` in one call a matrix. A run
makes a pool of distinct matrices and cycles through them, so that no
call meets the input of the call before it. Member i of the pool is the
same for a seed wherever it is made, so the reference makes its own copy
after the window.

The call: the traffic's ``"call"`` names a module of ``calls/``, which
makes it from ``tileqr_torch``, the configuration's ``qrconfig`` and the
traffic's ``"args"``.
"""

from __future__ import annotations

from typing import Callable, List

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
_GOLDEN = 0x9E3779B97F4A7C15


def member_seed(seed: int, i: int) -> int:
    """A generator seed for pool member i of a run's seed (any integer)."""
    return (seed * _GOLDEN + i * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def make_member(cell, seed: int, i: int, device) -> torch.Tensor:
    """Pool member i of ``seed``: the configuration's input distribution
    at its shape, made on ``device``."""
    params = dict(cell.config["input"])
    del params["distribution"]
    g = torch.Generator(device=device)
    g.manual_seed(member_seed(seed, i))
    return cell.inputs.make(tuple(cell.config["shape"]), DTYPES[cell.config["dtype"]], g,
                            device, **params)


def make_pool(cell, seed: int, size: int, device) -> List[torch.Tensor]:
    return [make_member(cell, seed, i, device) for i in range(size)]


def make_call(cell) -> Callable:
    """fn(a) → the program's raw result of the cell's call on a."""
    import tileqr_torch

    cfg = tileqr_torch.QRConfig(**cell.config["qrconfig"])
    return cell.call.make(tileqr_torch, cfg, cell.traffic.get("args", {}))

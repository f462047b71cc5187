"""A pr × pc process grid on ``torch.distributed``: the port's counterpart
of the ('rows', 'cols') ``jax.sharding.Mesh`` that tileqr's sharded drivers
run ``shard_map`` over.

Rank = r·pc + c holds mesh position (r, c). One row group per mesh row
(the ranks of tileqr's 'cols' axis) and one column group per mesh column
(the ranks of its 'rows' axis). The collectives the drivers use:

- ``broadcast(x, owner, axis)`` stands for tileqr's psum of a masked value
  (``psum(x · (col == owner), 'cols')``, or over both axes): every rank
  but the owner adds zeros, so the sum IS the owner's value, and a
  broadcast from the owner gives it exactly;
- ``ppermute_rows(x, pairs)`` is ``jax.lax.ppermute`` over 'rows' with
  static (src, dst) mesh-row pairs inside this rank's column: a
  ``batch_isend_irecv``; ranks that receive nothing get zeros, as from
  ppermute, and a rank with no pair makes no call (gloo's
  ``batch_isend_irecv`` refuses an empty list);
- ``all_gather(x, axis)``: the pieces stacked in axis-index order;
- ``psum(x, axis)`` is ``jax.lax.psum`` of an unmasked value (the sharded
  hr driver's grams and its projection W): ``all_reduce(SUM)`` on the
  axis group, in place. gloo's ring sums each segment on one rank and
  copies it to the others, so every rank of the group gets the same bits
  (``tests/test_torch_sharded_hr.py`` holds the replicated factors to
  that).

Under gloo, CUDA tensors go to the point-to-point ops and to all_gather
through a host copy (gloo moves CUDA tensors only for broadcast and
all_reduce, which it stages through the host itself). ``moved`` counts the
bytes each collective moved on this rank (broadcast and psum: the payload;
ppermute: sent plus received; all_gather: the gathered output) and ``staged`` the
bytes this module copied between the card and the host for gloo. NCCL
(every rank with a card of its own) moves CUDA tensors directly.

A (1, 1) mesh needs no process group: every collective is the identity on
the one rank, as ``shard_map`` on one device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """The (pr, pc) grid over the default process group (which must hold
    exactly pr·pc ranks), or over no group at all when pr·pc == 1. Every
    rank constructs it, in the same order as its other collectives (the
    process groups are created collectively)."""

    def __init__(self, pr: int, pc: int):
        if pr < 1 or pc < 1:
            raise ValueError(f"mesh shape ({pr}, {pc}) must be positive")
        self.pr, self.pc = pr, pc
        self.moved: Dict[str, int] = {"broadcast": 0, "ppermute": 0, "all_gather": 0,
                                      "psum": 0}
        self.staged = 0
        self._row_groups: List = []
        self._col_groups: List = []
        world = pr * pc
        if world == 1:
            self.rank, self.backend = 0, None
        else:
            if not dist.is_available() or not dist.is_initialized():
                raise RuntimeError(
                    f"a ({pr}, {pc}) mesh needs a process group of {world} ranks "
                    "(torch.distributed.init_process_group, or tileqr_torch.dist.launch)"
                )
            if dist.get_world_size() != world:
                raise ValueError(
                    f"a ({pr}, {pc}) mesh needs {world} ranks, the process group has "
                    f"{dist.get_world_size()}"
                )
            self.rank, self.backend = dist.get_rank(), dist.get_backend()
            self._row_groups = [dist.new_group([r * pc + j for j in range(pc)])
                                for r in range(pr)]
            self._col_groups = [dist.new_group([i * pc + c for i in range(pr)])
                                for c in range(pc)]
        self.r, self.c = divmod(self.rank, pc)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.pr, self.pc

    def rank_of(self, r: int, c: int) -> int:
        return r * self.pc + c

    def reset_counts(self) -> None:
        for k in self.moved:
            self.moved[k] = 0
        self.staged = 0

    def _stages(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        if not self._stages(x):
            return x
        self.staged += x.numel() * x.element_size()
        return x.cpu()

    def _to_device(self, host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if host.device == like.device:
            return host
        self.staged += host.numel() * host.element_size()
        return host.to(like.device)

    def _axis(self, axis: str):
        """(group, members' ranks, this rank's index in it) of an axis."""
        if axis == "cols":
            return (self._row_groups[self.r] if self._row_groups else None,
                    [self.rank_of(self.r, j) for j in range(self.pc)], self.c)
        if axis == "rows":
            return (self._col_groups[self.c] if self._col_groups else None,
                    [self.rank_of(i, self.c) for i in range(self.pr)], self.r)
        raise ValueError(f"axis {axis!r} must be 'cols' or 'rows'")

    def broadcast(self, x: torch.Tensor, owner, axis: str = "cols") -> torch.Tensor:
        """Every rank of the axis group gets the owner's x, in place (x must
        have the owner's shape and dtype everywhere). axis "cols": owner is
        a mesh column, the group this rank's mesh row; axis "both": owner is
        (r, c), the group the whole mesh. tileqr's psum of a masked value."""
        if axis == "both":
            group, src, size = None, self.rank_of(*owner), self.pr * self.pc
        else:
            group, members, _ = self._axis(axis)
            src, size = members[owner], len(members)
        if size == 1:
            return x
        dist.broadcast(x, src=src, group=group)
        self.moved["broadcast"] += x.numel() * x.element_size()
        return x

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of x over the axis group ('rows' or 'cols'), in place on
        x, on every rank of the group; the identity on a group of one."""
        group, members, _ = self._axis(axis)
        if len(members) == 1:
            return x
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        self.moved["psum"] += x.numel() * x.element_size()
        return x

    def ppermute_rows(self, x: torch.Tensor, pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute(x, 'rows', pairs)``: (src, dst) are mesh rows of
        this rank's column. Returns what this rank received, zeros when it
        receives nothing."""
        send_to = [dst for src, dst in pairs if src == self.r]
        recv_from = [src for src, dst in pairs if dst == self.r]
        if len(send_to) > 1 or len(recv_from) > 1:
            raise ValueError(f"pairs {tuple(pairs)} are not a permutation")
        ops, recv = [], None
        if send_to:
            ops.append(dist.P2POp(dist.isend, self._to_host(x.contiguous()),
                                  self.rank_of(send_to[0], self.c)))
        if recv_from:
            recv = torch.empty(x.shape, dtype=x.dtype,
                               device="cpu" if self._stages(x) else x.device)
            ops.append(dist.P2POp(dist.irecv, recv, self.rank_of(recv_from[0], self.c)))
        if not ops:
            return torch.zeros_like(x)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.moved["ppermute"] += x.numel() * x.element_size() * len(ops)
        return torch.zeros_like(x) if recv is None else self._to_device(recv, x)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(size, *x.shape): the axis group's pieces in axis-index order."""
        group, members, _ = self._axis(axis)
        if len(members) == 1:
            return x[None]
        host = self._to_host(x.contiguous())
        pieces = [torch.empty_like(host) for _ in members]
        dist.all_gather(pieces, host, group=group)
        out = torch.stack(pieces)
        self.moved["all_gather"] += out.numel() * out.element_size()
        return self._to_device(out, x)


def rank_device(device=None) -> torch.device:
    """Where this rank's non-tensor inputs go: ``device``, with "cuda" (the
    default) meaning the rank's own card, cuda:(rank % card count), in a
    process group."""
    if device not in (None, "cuda"):
        return torch.device(device)
    if torch.cuda.is_available() and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda")

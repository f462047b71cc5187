"""Run one function on every rank of a pr × pc world of spawned processes.

    from tileqr_torch.dist import launch
    out = launch.run_world(launch.sharded_case, 2, 2, kwargs=dict(a=a, config=cfg))

``run_world`` builds the CUDA kernel library in the parent first (so that
the ranks load it instead of running nvcc at once), starts pr·pc
processes with the "spawn" method, each of which joins a process group on
a free loopback port with a timeout on every collective, builds the
``Mesh`` and calls ``fn(mesh, **kwargs)``. It returns rank 0's result with
every tensor in it as numpy, and raises if any rank raises, dies or
outlasts the timeout (then the other ranks are terminated).

The backend is NCCL when every rank has a card of its own, else gloo: on
one card several ranks share ``cuda:0`` (NCCL refuses two ranks on one
device) and their CUDA contexts time-share it; on the CPU gloo is the only
choice. ``backend_for`` says which and why.

The rank-side runners live here, so that a spawned rank imports only
torch and tileqr_torch (a function is sent to a rank by its import path).
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

import tileqr_torch
from tileqr_torch import interop
from tileqr_torch.dist.mesh import Mesh, rank_device
from tileqr_torch.drivers import sharded
from tileqr_torch.kernels import _build


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: str, world: int) -> Tuple[str, str]:
    """(backend, reason) for a world of ``world`` ranks on ``device``."""
    if device == "cpu":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl", f"{world} ranks on {cards} cards, one card each"
    return "gloo", (f"{world} ranks share {cards} card(s) and NCCL refuses two ranks on one "
                    "device; gloo stages CUDA tensors through the host")


def to_numpy(x: Any) -> Any:
    """Tensors → numpy arrays, through dicts, lists, tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _rank_main(rank: int, spec: Dict[str, Any], results) -> None:
    """A rank's process: join the group, run fn, report to the parent."""
    try:
        if spec["device"] == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            spec["backend"], init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
            world_size=spec["pr"] * spec["pc"],
            timeout=datetime.timedelta(seconds=spec["timeout"]))
        try:
            out = spec["fn"](Mesh(spec["pr"], spec["pc"]), **spec["kwargs"])
            results.put((rank, None, to_numpy(out) if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))
        raise


def run_world(fn: Callable, pr: int, pc: int, kwargs: Optional[Dict[str, Any]] = None,
              device: str = "cpu", timeout: float = 600.0) -> Any:
    """``fn(mesh, **kwargs)`` on every rank of a pr × pc world; rank 0's
    result with its tensors as numpy. ``fn`` must be importable by name
    (a module-level function of a module that does not import jax).
    device: "cpu" (gloo) or "cuda" (the ranks' cards). timeout: seconds
    for the whole run and for each collective."""
    world = pr * pc
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_world(device='cuda') needs a CUDA device")
        _build.build()
    backend, _ = backend_for(device, world)
    spec = dict(fn=fn, kwargs=kwargs or {}, pr=pr, pc=pc, device=device, backend=backend,
                port=free_port(), timeout=timeout)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(rank, spec, results), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, err, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if i not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "before it reported")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {pr}x{pc} world did not finish in {timeout} s")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of the {pr}x{pc} world failed:\n{err}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return got[0]


# ---- rank-side runners ----

def run_cases(mesh: Mesh, cases: List[Tuple[str, Dict[str, Any]]]) -> List[Any]:
    """Several runners in one world: cases are (name in RUNNERS, kwargs)."""
    return [RUNNERS[name](mesh, **kw) for name, kw in cases]


def _gather_to_list(x: Any) -> List[Any]:
    """Every rank's x as numpy, in rank order (pickled: small values only)."""
    if not dist.is_initialized():
        return [to_numpy(x)]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, to_numpy(x))
    return out


def probe_collectives(mesh: Mesh) -> List[Dict[str, Any]]:
    """Each Mesh collective with rank-tagged values, every rank's outputs
    gathered in rank order: broadcast over 'cols' from each mesh column
    and over both axes from each rank (the non-owners pass garbage, which
    must not leak), ppermute over 'rows' with every level of every
    rotation of the tree (zeros where nothing arrives, no call where a rank
    has no pair) and the all_gathers over both axes; and the jax, jaxlib
    or tileqr modules the rank has imported (none)."""
    rank = mesh.rank
    tag = torch.full((3,), float(rank + 1), dtype=torch.float64)
    out: Dict[str, Any] = {"coords": (mesh.r, mesh.c), "foreign_modules": sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tileqr"))}
    out["bcast_cols"] = [mesh.broadcast(tag.clone() if mesh.c == o else tag * -7.0, o, "cols")
                         for o in range(mesh.pc)]
    out["bcast_both"] = [
        mesh.broadcast(tag.clone() if (mesh.r, mesh.c) == (r, c) else tag * -7.0, (r, c), "both")
        for r in range(mesh.pr) for c in range(mesh.pc)]
    perms = {}
    for r_k in range(mesh.pr):
        for li, (down, up, _) in enumerate(sharded._tree_perms(mesh.pr, r_k)):
            perms[(r_k, li, "down")] = mesh.ppermute_rows(tag, down)
            perms[(r_k, li, "up")] = mesh.ppermute_rows(tag, up)
    out["perms"] = perms
    out["gather_cols"] = mesh.all_gather(tag, "cols")
    out["gather_rows"] = mesh.all_gather(tag, "rows")
    out["moved"] = dict(mesh.moved)
    return _gather_to_list(out)


def raise_probe(mesh: Mesh) -> Dict[str, str]:
    """The errors a wrong world size and the unported hr route raise."""
    out = {}
    for name, fn in (
            ("world", lambda: Mesh(mesh.pr + 1, mesh.pc)),
            ("hr", lambda: tileqr_torch.qr_sharded(
                torch.zeros((8, 8)), mesh, tileqr_torch.QRConfig(nb=8, square_method="hr")))):
        try:
            fn()
            out[name] = "no error"
        except (ValueError, NotImplementedError) as e:
            out[name] = type(e).__name__
    return out


def sharded_case(mesh: Mesh, a: np.ndarray, config, chunk: Optional[int] = None,
                 c: Optional[np.ndarray] = None, device: str = "cpu",
                 gather_factors: bool = False) -> Optional[Dict[str, Any]]:
    """The sharded path on the numpy A (the same on every rank): the factor
    at ``chunk`` (None: ``qr_sharded``'s rule), R, Qᵀ·A, Q·C and Q·(Qᵀ·C)
    for C = c (A when None), a rerun's R, rank 0's kernel launches and
    plain-version calls in the factor beside the geometry's plan and, with
    ``gather_factors``, every rank's factors. Returns them on rank 0."""
    dev = rank_device(device)
    at = torch.as_tensor(a, dtype=config.dtype, device=dev)
    ct = at if c is None else torch.as_tensor(c, dtype=config.dtype, device=dev)

    def factor():
        if chunk is None:
            return tileqr_torch.qr_sharded(at, mesh, config, mode="factor")
        return sharded.qr_sharded_factor(at, mesh, config.nb, config.ib, chunk, config.precision)

    _build.reset_counts()
    f = factor()
    out = dict(
        launches=dict(_build.LAUNCHES), plain=dict(_build.PLAIN_CALLS),
        planned=sharded.planned_launches(f.grid, f.chunk, mesh.r), chunk=f.chunk,
        r=tileqr_torch.assemble_r_sharded(f, mesh),
        qta=tileqr_torch.apply_q_sharded(f, at, mesh, trans=True, config=config),
        qc=tileqr_torch.apply_q_sharded(f, ct, mesh, trans=False, config=config),
        r2=tileqr_torch.assemble_r_sharded(factor(), mesh),
    )
    out["qqtc"] = tileqr_torch.apply_q_sharded(
        f, tileqr_torch.apply_q_sharded(f, ct, mesh, trans=True, config=config), mesh,
        trans=False, config=config)
    if gather_factors:
        out["factors"] = _gather_to_list(f)
    return out if mesh.rank == 0 else None


def interop_case(mesh: Mesh, factors: Dict[str, Any], c: np.ndarray, config) -> Dict[str, Any]:
    """tileqr's ShardedDynFactors (as numpy, every rank's buffers) carried
    to this rank by ``interop``, then applied by the port: Qᵀ·C and Q·C."""
    f = interop.sharded_factors_from_numpy(factors, (mesh.r, mesh.c), dtype=config.dtype)
    ct = torch.as_tensor(c, dtype=config.dtype)
    return dict(qtc=tileqr_torch.apply_q_sharded(f, ct, mesh, trans=True, config=config),
                qc=tileqr_torch.apply_q_sharded(f, ct, mesh, trans=False, config=config))


RUNNERS: Dict[str, Callable] = {
    "collectives": probe_collectives,
    "raises": raise_probe,
    "sharded": sharded_case,
    "interop": interop_case,
}

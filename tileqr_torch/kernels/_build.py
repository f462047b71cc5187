"""Build, load and count the CUDA kernels.

At first use, every ``tileqr_torch/csrc/*.cu`` file is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` process per source, all started together),
linked into one shared library with a plain C interface under
``build/tileqr_torch/<hash of the sources>/``, and loaded with ``ctypes``.
Nothing is compiled or loaded when a module is imported, and nothing falls
back: a CUDA tensor with no ``nvcc`` raises. ``NVCC_FLAGS`` carries no
``--use_fast_math``: the Kahan compensation of ``panel_apply_carry``
needs its float ops kept as written.

The launch and call counts let a run show which path it took: each CUDA
wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel, and
each plain version adds one to ``PLAIN_CALLS[name]``: one count per call.
K1 and K3 take the name to count under (``counter``) where they stand for
another TPU kernel (``SITE_KERNELS``). The kernels whose
products follow ``QRConfig.precision`` count each instantiation apart:
``name`` for "highest", ``name[b3]``, ``name[b4]`` and ``name[default]``
for the split products ("high" runs the b3 instantiation), so a run shows
which mode it took (``common.counter_key``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from tileqr_torch.core import trace

HH_KERNELS = ("panel_factor", "panel_chain", "couple_strip", "larfb_strip")
HR_KERNELS = ("modified_lu", "potrf_batched", "panel_apply_carry")
# the batched GEQRT's four routes, counted apart: the one-block kernel
# (its tile in global memory: m < n past the small route), the cluster
# route (small stacks, one thread-block cluster a matrix), the small route
# (a matrix a CTA) and the tall route (panels in shared memory, a
# persistent CTA a leaf: the tsqr leaves and the tree's level 1)
TS_KERNELS = ("geqrt_batched", "geqrt_batched[cluster]", "geqrt_batched[small]",
              "geqrt_batched[tall]")
# B7, the value-level whole-panel apply of the hr apply_q/orgqr
APPLY_KERNELS = ("panel_apply",)
# B15's TTQRT, the combine of the sharded tree
SHARDED_KERNELS = ("ttqrt",)
# B7's halves, the sharded hr driver's update with its sum over mesh rows
# between them
SHARDED_HR_KERNELS = ("panel_project", "panel_sub")
# TPU kernels that the sharded path runs on another's CUDA kernel, each
# launch counted under the TPU kernel's name instead of the CUDA kernel's:
# B13 panel_head is K1 on a rank's panel column, B15 ssrfb (the strip
# tree's TTMQR) is K3 with one couple, keyed by mode as K3 is
SITE_KERNELS = ("panel_head", "ssrfb")
# the kernels with a split-product instantiation per emulated mode
MODE_KERNELS = ("couple_strip", "larfb_strip", "panel_apply_carry", "panel_apply",
                "panel_project", "panel_sub")
EMULATED_MODES = ("b3", "b4", "default")
KERNELS = (HH_KERNELS + HR_KERNELS + TS_KERNELS + APPLY_KERNELS + SHARDED_KERNELS
           + SHARDED_HR_KERNELS + SITE_KERNELS
           + tuple(f"{k}[{m}]" for k in MODE_KERNELS + ("ssrfb",) for m in EMULATED_MODES))
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}
# K1/K2 launches that ran their couple chain pipelined by ib block
# (``csrc/panel_pipe.cuh``), and their couple steps that ran overlapped (a
# step's later blocks beside the next step's first): every step of such a
# launch but its last
PIPELINE = {"launches": 0, "overlapped_steps": 0}
# launches of the cluster routine (``csrc/geqrt_cluster.cuh``: K1, K2, their
# pipelined launch, TTQRT, the batched GEQRT's cluster route) on clusters of
# more than one CTA, and the columns whose partials they exchanged between
# CTAs (st.async into the peers' mbarriers), over all their clusters;
# counted by the launchers from their plans (``count_exchange``)
EXCHANGE = {"launches": 0, "columns": 0}
# K3's launches by their plan (``chain.strip_plan``): {(stage 1's tile, G,
# stage 3's tile): {"launches", "couples"}} with the couples they swept;
# counted by K3's launcher (``count_strip``). K4's are LAUNCHES["larfb_strip"]
STRIP: dict = {}
# K3's chain launches by their row bands a 64-column block
# (``chain.chain_bands``): {bands: {"launches", "couples"}} with the couples
# they swept; counted by K3's launcher (``count_chain``), K4's not
CHAIN: dict = {}
# fp32 phase-1 launches (B6, B7, B7a in "highest") by their schedule
# (``panel_apply.project_plan``): the balanced persistent grid or the
# whole-tile grid, and the chains the balanced launches handed between
# blocks; counted by phase 1's launcher (``count_project``)
PROJECT = {"balanced": 0, "whole_tiles": 0, "handed": 0}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tileqr_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of every C function of csrc/*.cu
SIGNATURES = {
    # a, lda, k, nb, ib, n_couples, r_out, v_stack, t_geqrt, t2_stack, work,
    # ctas, smem, resident, stream
    "tq_panel_factor": (_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _L, _I, _P),
    # a, lda, r_in, k, nb, base_block, n_chunks, block_rows, ib,
    # r_out, v_chunks, t2, work, ctas, smem, resident, stream
    "tq_panel_chain": (_P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _L, _I, _P),
    # K1/K2 cluster workspace floats (int64): nb, rows, ib, ctas, resident
    "tq_cluster_work_floats": (_I, _I, _I, _I, _I),
    # the pipelined chain (csrc/panel_pipe.cuh: TQ_PIPE_PARAMS): a, lda, k,
    # nb, ib, rows, geqrt, n_head, n_chunks, block_rows, chunk_row0, r_in,
    # r_out, v_stack, t_geqrt, t2_stack, v_chunks, t2_chunks, work, sync,
    # epoch, stages, ctas, smem, resident, stream
    "tq_panel_pipe": (_P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _L, _I, _I, _L, _I, _P),
    # v_stack, t2_stack, c, ldc, strip, lds, width, stack_base, base_block,
    # n_chunks, block_rows, nb, col_start, trans, reverse, vkk, tg, passes,
    # work, the plan (proj tile rows, columns, groups, sub tile rows,
    # columns, bands: kernels/chain.py:strip_plan), stream
    "tq_couple_strip": (
        _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
        _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    # vkk, tg, strip, lds, width, nb, trans, passes, work, bands, stream
    "tq_larfb_strip": (_P, _P, _P, _L, _I, _I, _I, _I, _P, _I, _P),
    # q, lu, n, d, ctas, smem, resident, stream
    "tq_modified_lu": (_P, _P, _I, _P, _I, _L, _I, _P),
    # g, r, batch, n, bp, ctas, threads, smem, resident (kernels/potrf.py:potrf_plan),
    # stream
    "tq_potrf_batched": (_P, _P, _I, _I, _I, _I, _I, _L, _I, _P),
    # y, tm (or NULL), c, ldc, m, n, nb, mr, w, work (or NULL), groups,
    # ranges (0: the whole-tile grid), passes, stream
    "tq_panel_project": (_P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    # y, w, c, ldc, m, n, nb, tile rows, tile columns
    # (kernels/panel_apply.py:sub_plan), passes, stream
    "tq_panel_sub": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    # geqrt_batched blocks to launch (or -cudaError): batch, m
    "tq_geqrt_batched_grid": (_L, _I),
    # geqrt_batched workspace floats per block: m, n, ib
    "tq_geqrt_batched_work_floats": (_I, _I, _I),
    # a, packed, t, work, batch, m, n, kcols, ib, grid, stream
    "tq_geqrt_batched": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # the small route: a, packed, t, batch, m, n, ib, threads, smem, stream
    "tq_geqrt_small": (_P, _P, _P, _I, _I, _I, _I, _I, _L, _P),
    # small-route CTAs an SM holds (or -cudaError): m, n, ib, threads
    "tq_geqrt_small_per_sm": (_I, _I, _I, _I),
    # a, packed, t, work, batch, m, n, ib, ctas, smem, resident, stream
    "tq_geqrt_batched_cluster": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P),
    # the tall route: a, packed, t, work, ops, nops, batch, m, n, ibm, w,
    # vec, grid, smem (kernels/geqrt.py:tall_plan), stream
    "tq_geqrt_tall": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _L, _P),
    # tall-route CTAs an SM holds (or -cudaError): m, w
    "tq_geqrt_tall_per_sm": (_I, _I),
    # r1, r2, nb, ib, r_out, v2, t2, work, ctas, smem, resident, stream
    "tq_ttqrt": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _L, _I, _P),
}

# the C functions that return something other than an int
RESTYPES = {"tq_cluster_work_floats": ctypes.c_int64}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in PIPELINE:
        PIPELINE[k] = 0
    for k in EXCHANGE:
        EXCHANGE[k] = 0
    for k in PROJECT:
        PROJECT[k] = 0
    STRIP.clear()
    CHAIN.clear()
    for k in trace.LOOKAHEAD:
        trace.LOOKAHEAD[k] = 0
    for k in trace.HR_APPLY:
        trace.HR_APPLY[k] = 0
    trace.GUARD.clear()


def count_exchange(ctas: int, columns: int) -> None:
    """Count one launch of the cluster routine on clusters of ``ctas`` CTAs
    whose column loops walk ``columns`` columns in all (``EXCHANGE``); a
    cluster of one CTA exchanges nothing."""
    if ctas > 1:
        EXCHANGE["launches"] += 1
        EXCHANGE["columns"] += columns


def count_project(ranges: int, handed: int) -> None:
    """Count one fp32 phase-1 launch in ``PROJECT``: balanced over
    ``ranges`` blocks with ``handed`` chains handed on, or (ranges = 0) on
    the whole-tile grid."""
    PROJECT["balanced" if ranges else "whole_tiles"] += 1
    PROJECT["handed"] += handed


def count_strip(key: tuple, couples: int) -> None:
    """Count one K3 launch at the plan ``key`` (stage 1's tile, G, stage
    3's tile) that swept ``couples`` couples in ``STRIP``."""
    ent = STRIP.setdefault(key, {"launches": 0, "couples": 0})
    ent["launches"] += 1
    ent["couples"] += couples


def count_chain(bands: int, couples: int) -> None:
    """Count one K3 chain launch on ``bands`` row bands a block that swept
    ``couples`` couples in ``CHAIN``."""
    ent = CHAIN.setdefault(bands, {"launches": 0, "couples": 0})
    ent["launches"] += 1
    ent["couples"] += couples


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "tileqr_torch: a CUDA tensor needs the CUDA kernels, but nvcc was not "
        "found (set CUDA_HOME or put nvcc on PATH)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtileqr_torch.so"


def build() -> Path:
    """Compile the sources if their library is not built yet."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, p.stem + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)] for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        errs = [p.communicate()[1] for p in procs]
        failed = [(c, p.returncode, e) for c, p, e in zip(cmds, procs, errs)
                  if p.returncode != 0]
        if not failed:
            tmp = os.path.join(tmpdir, out.name)
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = [(cmd, proc.returncode, proc.stderr)]
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}" for cmd, rc, err in failed
            ))
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        handle.tq_error_string.argtypes = [ctypes.c_int]
        handle.tq_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib().tq_error_string(rc).decode()
        raise RuntimeError(f"tileqr_torch kernel {name} failed: {msg} ({rc})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# the card's facts the launch plans read: the shared memory one CTA may
# have on the H100, in bytes, and the thread-block cluster sizes the
# cluster kernels are launched at
SMEM_LIMIT = 232448
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the card holding t (the launch plans'
    ``sms``)."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when all are on the
    CPU; raises on a mix or on any other device."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"tileqr_torch kernels take CPU or CUDA tensors, got {devs}")


def require_fp32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(
                f"tileqr_torch CUDA kernels take float32, got {t.dtype}"
            )


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def require_row_major(**tensors: torch.Tensor) -> None:
    """2-D tensors addressed by (pointer, leading dimension): unit column
    stride required."""
    for name, t in tensors.items():
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"{name} must be 2-D with unit column stride")

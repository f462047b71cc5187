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

HH_KERNELS = ("panel_factor", "panel_chain", "couple_strip", "larfb_strip")
HR_KERNELS = ("modified_lu", "potrf_batched", "panel_apply_carry")
TS_KERNELS = ("geqrt_batched",)
# B7, the value-level whole-panel apply of the hr apply_q/orgqr
APPLY_KERNELS = ("panel_apply",)
# B15's TTQRT, the combine of the sharded tree
SHARDED_KERNELS = ("ttqrt",)
# TPU kernels that the sharded path runs on another's CUDA kernel, each
# launch counted under the TPU kernel's name instead of the CUDA kernel's:
# B13 panel_head is K1 on a rank's panel column, B15 ssrfb (the strip
# tree's TTMQR) is K3 with one couple, keyed by mode as K3 is
SITE_KERNELS = ("panel_head", "ssrfb")
# the kernels with a split-product instantiation per emulated mode
MODE_KERNELS = ("couple_strip", "larfb_strip", "panel_apply_carry", "panel_apply")
EMULATED_MODES = ("b3", "b4", "default")
KERNELS = (HH_KERNELS + HR_KERNELS + TS_KERNELS + APPLY_KERNELS + SHARDED_KERNELS
           + SITE_KERNELS
           + tuple(f"{k}[{m}]" for k in MODE_KERNELS + ("ssrfb",) for m in EMULATED_MODES))
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {k: 0 for k in KERNELS}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tileqr_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of every C function of csrc/*.cu
SIGNATURES = {
    # a, lda, k, nb, ib, n_couples, r_out, v_stack, t_geqrt, t2_stack, work, stream
    "tq_panel_factor": (_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # a, lda, r_in, k, nb, base_block, n_chunks, block_rows, ib,
    # r_out, v_chunks, t2, work, stream
    "tq_panel_chain": (_P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # v_stack, t2_stack, c, ldc, strip, lds, width, stack_base, base_block,
    # n_chunks, block_rows, nb, col_start, trans, reverse, vkk, tg, passes,
    # stream
    "tq_couple_strip": (
        _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P,
    ),
    # vkk, tg, strip, lds, width, nb, trans, passes, stream
    "tq_larfb_strip": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # panel_factor / panel_chain workspace size in floats: nb, rows, ib
    "tq_geqrt_work_floats": (_I, _I, _I),
    # lu (in place), n, d, stream
    "tq_modified_lu": (_P, _I, _P, _P),
    # r (in place), batch, n, bp, stream
    "tq_potrf_batched": (_P, _I, _I, _I, _P),
    # y, tm (or NULL), c, ldc, m, n, nb, mr, w, passes, stream
    "tq_panel_project": (_P, _P, _P, _L, _I, _I, _I, _I, _P, _I, _P),
    # y, w, c, ldc, m, n, nb, passes, stream
    "tq_panel_sub": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # geqrt_batched blocks to launch (or -cudaError): batch, m, n, resident
    "tq_geqrt_batched_grid": (_L, _I, _I, _I),
    # geqrt_batched workspace floats per block: m, n, ib, resident
    "tq_geqrt_batched_work_floats": (_I, _I, _I, _I),
    # a, packed, t, work, batch, m, n, kcols, ib, resident, grid, stream
    "tq_geqrt_batched": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    # r1, r2, nb, ib, r_out, v2, t2, work, stream
    "tq_ttqrt": (_P, _P, _I, _I, _P, _P, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


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
            fn.restype = ctypes.c_int
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

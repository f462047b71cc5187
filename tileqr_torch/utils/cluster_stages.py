"""Where the cluster kernels' time goes, stage by stage, on the card.

    python -m tileqr_torch.utils.cluster_stages [--n 8192] [--reps 5]
        [--rows-per-cta 160 80] [--ttqrt-ctas 4 8] [--modlu-nb 256 512]

Builds the kernels a second time with ``TQ_CL_STAGES`` defined (a copy of
``csrc/`` under ``build/``), which makes thread 0 of the cluster's CTA 0
add the ``globaltimer`` nanoseconds of each stage of
``csrc/geqrt_cluster.cuh`` to a device counter: the slab's load and store,
P = Vbᵀ[V_prev | Vb | A_rest] with its cluster reduction, the block T, the
off-diagonal T, the block apply, and the column loop's three phases (the
dots, the exchange of partials with its cluster barrier, LARFG with the
rank-1 update). Runs K1 (GEQRT and 3 head
couples) and K2 (7 couples of 4·nb rows) at ``chip_smoke.py`` phase 1's
shapes on a gaussian A and prints each stage's mean ms per call beside the
call's time from CUDA events (the instrumented build; the timer adds one
global store per stage), for each ``--rows-per-cta`` value given (the
rows a CTA the cluster plan aims at, ``kernels/panel.py:ROWS_PER_CTA``;
default: the plan's own). TTQRT (``csrc/ttqrt.cu``, the same routine on
the live rows) on two upper-triangular (nb, nb) tiles: the same stages,
at each ``--ttqrt-ctas`` (default: ``ttqrt_plan``'s). B8 (``csrc/modlu.cu``)
on an orthonormal factor's top block at each ``--modlu-nb``: every CTA's
time in the block's load and store, its own panels' column loops, the
cluster barriers (with the wait for each panel's owner), the copies of L's
panel, U12 and the trailing product. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from tileqr_torch.kernels import _build
from tileqr_torch.utils.plan_sweep import cuda_ms, ttqrt_at, ttqrt_plan_at

STAGES = ("slab load/store", "P + reduction", "block T", "off-diagonal T", "apply",
          "column dots", "exchange + cluster barrier", "LARFG + rank-1 update")
LU_STAGES = ("load/store", "own panels", "cluster barrier", "L copy", "U12", "trailing")


def instrumented_lib() -> ctypes.CDLL:
    """The kernel library built from a copy of csrc/ with TQ_CL_STAGES."""
    src = _build.BUILD_ROOT.parent / "tileqr_torch_stages" / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(_build.CSRC, src)
    head = src / "geqrt_cluster.cuh"
    head.write_text("#define TQ_CL_STAGES 1\n" + head.read_text())
    _build.CSRC = src
    handle = _build.lib()
    for name in ("tq_cl_stages_panel", "tq_cl_stages_chain", "tq_cl_stages_ttqrt",
                 "tq_lu_stages"):
        getattr(handle, name).argtypes = [ctypes.c_void_p]
        getattr(handle, name).restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--nb", type=int, default=256)
    ap.add_argument("--ib", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows-per-cta", type=int, nargs="+", default=None)
    ap.add_argument("--ttqrt-ctas", type=int, nargs="+", default=None)
    ap.add_argument("--modlu-nb", type=int, nargs="+", default=[256, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_stages: needs a CUDA device")
        return 1
    from tileqr_torch.kernels import chain, modlu, panel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    lib = instrumented_lib()
    nb, ib, c = args.nb, args.ib, args.chunk
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.n, nb), dtype=np.float32)).cuda()
    n_head = c - 1
    n_chunks = (args.n // nb - 1 - n_head) // c
    r_k = panel.panel_factor(a, 0, nb, ib, n_head)[0]
    calls = {
        "panel_factor": (lambda: panel.panel_factor(a, 0, nb, ib, n_head),
                         lib.tq_cl_stages_panel, 2 * nb),
        "panel_chain": (lambda: chain.panel_chain(a, r_k, 0, nb, 1, n_chunks, c * nb, ib),
                        lib.tq_cl_stages_chain, nb + c * nb),
    }
    out = (ctypes.c_ulonglong * len(STAGES))()
    for rows_per_cta in args.rows_per_cta or [panel.ROWS_PER_CTA]:
        panel.ROWS_PER_CTA = rows_per_cta
        for name, (fn, read, rows) in calls.items():
            time_stages(name, fn, read, panel.cluster_plan(nb, rows, ib), out, args.reps)
    rng = np.random.default_rng(1)
    r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).cuda()
              for _ in range(2))
    for ctas in args.ttqrt_ctas or [None]:
        plan = panel.ttqrt_plan(nb, ib) if ctas is None else ttqrt_plan_at(nb, ib, ctas)
        time_stages("ttqrt", lambda: ttqrt_at(r1, r2, ib, plan), lib.tq_cl_stages_ttqrt,
                    plan, out, args.reps)
    lu_out = (ctypes.c_ulonglong * (16 * len(LU_STAGES)))()
    for n in args.modlu_nb:
        q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((4 * n, n))).cuda())
        q_top = q[:n].float().contiguous()
        time_lu_stages(lambda: modlu.modified_lu(q_top), lib.tq_lu_stages, modlu.modlu_plan(n),
                       n, lu_out, args.reps)
    return 0


def time_lu_stages(fn, read, plan, n: int, out, reps: int) -> None:
    """B8's time by CUDA events and every CTA's stages by the device timer."""
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), "modified_lu")
    ms = cuda_ms(fn, reps)
    _build.check(read(ctypes.addressof(out)), "modified_lu")
    print(f"modified_lu nb={n} {plan}: {ms:.3f} ms per call (CUDA events)")
    k = len(LU_STAGES)
    for r in range(plan.ctas):
        split = [out[r * k + i] / 1e6 / reps for i in range(k)]
        print(f"  CTA {r}: " + ", ".join(f"{s} {t:.4f} ms" for s, t in zip(LU_STAGES, split)))


def time_stages(name, fn, read, plan, out, reps: int) -> None:
    """One call's time by CUDA events and its stages by the device timer."""
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), name)
    ms = cuda_ms(fn, reps)
    _build.check(read(ctypes.addressof(out)), name)
    split = [v / 1e6 / reps for v in out]
    print(f"{name} {plan}: {ms:.3f} ms per call (CUDA events); "
          f"stages on CTA 0: " + ", ".join(
              f"{s} {t:.3f} ms ({t / max(sum(split), 1e-9):.1%})"
              for s, t in zip(STAGES, split)))


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the cluster kernels' time goes, stage by stage, on the card.

    python -m tileqr_torch.utils.cluster_stages [--n 8192] [--reps 5]
        [--rows-per-cta 160 80] [--ttqrt-ctas 4 8] [--modlu-nb 256 512]
        [--potrf 1x256 1x512 4096x128] [--small 1x32 4096x32 1x128 4096x128]
        [--tall 512 128] [--only cluster modlu potrf small tall]

Builds the kernels a second time with ``TQ_CL_STAGES`` defined (a copy of
``csrc/`` under ``build/``), which makes thread 0 of the cluster's CTA 0
add the ``globaltimer`` nanoseconds of each stage of
``csrc/geqrt_cluster.cuh`` to a device counter: the slab's load and store,
P = Vbᵀ[V_prev | Vb | A_rest] with its cluster reduction, the block T, the
off-diagonal T, the block apply, and the column loop's three phases (the
dots, the exchange of partials by st.async with its wait, LARFG with the
rank-1 update), and in a pipelined launch (``csrc/panel_pipe.cuh``) each
stage's wait on the hand-off flag of the stage before it. Runs K1 (GEQRT
and 3 head couples), K2 (7 couples of 4·nb rows) and the two in one launch
(``chain.panel_column``, the hh driver's panel 0) at ``chip_smoke.py``
phase 1's shapes on a gaussian A, each pipelined by ib block, and prints
each stage cluster's mean ms per call in every stage, with its share of
the cluster's time, beside the call's time from CUDA events (the
instrumented build; the timer adds one global store per stage), for each
``--rows-per-cta`` value given (the rows a CTA the cluster plan aims at,
``kernels/geqrt.py:ROWS_PER_CTA``; default: the plan's own); the stage
clusters' busy times (all but the wait) give the balance of the ib blocks. TTQRT (``csrc/ttqrt.cu``, the same routine on
the live rows) on two upper-triangular (nb, nb) tiles: the same stages,
at each ``--ttqrt-ctas`` (default: ``ttqrt_plan``'s). B8 (``csrc/modlu.cu``)
on an orthonormal factor's top block at each ``--modlu-nb``: every CTA's
time in the block's load and store, its own panels' column loops, the
cluster barriers (with the wait for each panel's owner), the copies of L's
panel, U12 and the trailing product. B9 (``csrc/potrf.cu``) on the gram of
a gaussian (2n, n) for each ``--potrf`` BxN: every CTA of the first
cluster's time in the blocks' load and store, its own panels' row steps,
the cluster barriers, the panel copies and the SYRKs. The batched GEQRT's
small route (``csrc/geqrt_small.cu``) on a gaussian (B, 128, 128) stack for
each ``--small`` BxIB: CTA 0's time in the tile's load, LARFG, warp 0's
dots and updates, the column barriers, T's 32-column sub-blocks by rows,
their joins, the block apply with its off-diagonal T, and the stores. Its
tall route (``csrc/geqrt_tall.cu``) on a gaussian (B, 2048, 512) stack at
ib 128 for each ``--tall`` B (512: the tsqr leaves, 128: the tree's level
1): CTA 0's time over all its matrices in the copy-in and the panels'
loads, the panels' stores, the inner T (each panel's larft and the joins
within a block), the updates within a block, the trailing updates, the
off-diagonal T of each block against the ones before it, and the column
loops in three (the warps' sums with LARFG, the pass over the rows, the
warp sums with the barrier). Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from tileqr_torch.kernels import _build
from tileqr_torch.utils.plan_sweep import cuda_ms

SMALL_STAGES = ("load", "LARFG", "warp 0 dots + updates", "column barrier",
                "T sub-blocks by rows", "T sub-blocks joined", "block apply + off-diagonal T",
                "store")
PO_STAGES = ("load/store", "own row steps", "cluster barrier", "panel copy", "SYRK")
STAGES = ("slab load/store", "P + reduction", "block T", "off-diagonal T", "apply",
          "column dots", "exchange + wait", "LARFG + rank-1 update",
          "hand-off wait")
# the stage timer's rows (csrc/geqrt_cluster.cuh: CL_SLOTS): one a stage
# cluster of a pipelined launch (stages past them untimed), row 0 for one
# cluster
CL_SLOTS = 8
LU_STAGES = ("load/store", "own panels", "cluster barrier", "L copy", "U12", "trailing")
TALL_STAGES = ("copy-in + panel loads", "panel stores", "inner T", "in-block update",
               "trailing update", "off-diagonal T", "column loop: sums + LARFG",
               "column loop: rows", "column loop: warp sums + barrier")


def instrumented_lib() -> ctypes.CDLL:
    """The kernel library built from a copy of csrc/ with TQ_CL_STAGES."""
    src = _build.BUILD_ROOT.parent / "tileqr_torch_stages" / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(_build.CSRC, src)
    for f in ("geqrt_cluster.cuh", "geqrt_small.cu", "geqrt_tall.cu"):
        head = src / f
        head.write_text("#define TQ_CL_STAGES 1\n" + head.read_text())
    _build.CSRC = src
    handle = _build.lib()
    for name in ("tq_cl_stages_panel", "tq_cl_stages_chain", "tq_cl_stages_ttqrt",
                 "tq_lu_stages", "tq_potrf_stages", "tq_small_stages", "tq_tall_stages"):
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
    ap.add_argument("--potrf", nargs="+", default=["1x256", "1x512", "4096x128"])
    ap.add_argument("--small", nargs="+", default=["1x32", "4096x32", "1x128", "4096x128"])
    ap.add_argument("--tall", type=int, nargs="+", default=[512, 128])
    ap.add_argument("--only", nargs="+", choices=("cluster", "modlu", "potrf", "small", "tall"),
                    default=["cluster", "modlu", "potrf", "small", "tall"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_stages: needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    lib = instrumented_lib()
    rng = np.random.default_rng(1)
    if "cluster" in args.only:
        cluster_kernels(args, lib, rng)
    if "modlu" in args.only:
        from tileqr_torch.kernels import modlu

        lu_out = (ctypes.c_ulonglong * (16 * len(LU_STAGES)))()
        for n in args.modlu_nb:
            q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((4 * n, n))).cuda())
            q_top = q[:n].float().contiguous()
            time_lu_stages(lambda: modlu.modified_lu(q_top), lib.tq_lu_stages,
                           modlu.modlu_plan(n), n, lu_out, args.reps)
    if "potrf" in args.only:
        from tileqr_torch.kernels import potrf

        po_out = (ctypes.c_ulonglong * (16 * len(PO_STAGES)))()
        for shape in args.potrf:
            b, n = (int(v) for v in shape.split("x"))
            x = torch.from_numpy(rng.standard_normal((b, 2 * n, n), dtype=np.float32)).cuda()
            g = x.transpose(1, 2) @ x
            del x
            time_cta_stages(f"potrf_batched ({b}, {n}, {n})", lambda: potrf.potrf_batched(g),
                            lib.tq_potrf_stages, potrf.potrf_plan(b, n, _build.sm_count(g)),
                            PO_STAGES, po_out, args.reps)
            del g
    if "small" in args.only:
        from tileqr_torch.kernels import geqrt

        sm_out = (ctypes.c_ulonglong * len(SMALL_STAGES))()
        for shape in args.small:
            b, ib = (int(v) for v in shape.split("x"))
            a = torch.from_numpy(rng.standard_normal((b, 128, 128), dtype=np.float32)).cuda()
            time_stages(f"geqrt_batched[small] ({b}, 128, 128) ib={ib}",
                        lambda: geqrt.geqrt_batched(a, ib), lib.tq_small_stages,
                        geqrt.batched_plan(b, 128, 128, ib, _build.sm_count(a)), sm_out,
                        args.reps, SMALL_STAGES)
            del a
    if "tall" in args.only:
        from tileqr_torch.kernels import geqrt

        tl_out = (ctypes.c_ulonglong * len(TALL_STAGES))()
        for b in args.tall:
            a = torch.from_numpy(rng.standard_normal((b, 2048, 512), dtype=np.float32)).cuda()
            plan = geqrt.tall_plan(b, 2048, 512, args.ib, _build.sm_count(a))
            time_stages(f"geqrt_batched[tall] ({b}, 2048, 512) ib={args.ib}",
                        lambda: geqrt._geqrt_tall(a, plan), lib.tq_tall_stages, plan, tl_out,
                        max(1, args.reps // 5), TALL_STAGES)
            del a
            torch.cuda.empty_cache()
    return 0


def cluster_kernels(args, lib, rng) -> None:
    """K1, K2 and the two in one launch (each pipelined, a row of stages a
    stage cluster) and TTQRT's stages (``csrc/geqrt_cluster.cuh``)."""
    from tileqr_torch.kernels import chain, geqrt, panel, ttqrt

    nb, ib, c = args.nb, args.ib, args.chunk
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.n, nb), dtype=np.float32)).cuda()
    n_head = c - 1
    n_chunks = (args.n // nb - 1 - n_head) // c
    r_k = panel.panel_factor(a, 0, nb, ib, n_head)[0]
    calls = {
        "panel_factor": (lambda: panel.panel_factor(a, 0, nb, ib, n_head),
                         (1 + n_head, 2 * nb, False)),
        "panel_chain": (lambda: chain.panel_chain(a, r_k, 0, nb, 1, n_chunks, c * nb, ib),
                        (n_chunks, nb + c * nb, True)),
        "panel_column": (lambda: chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, c * nb),
                         (1 + n_head + n_chunks, nb + c * nb, False)),
    }
    out = (ctypes.c_ulonglong * (CL_SLOTS * len(STAGES)))()
    for rows_per_cta in args.rows_per_cta or [geqrt.ROWS_PER_CTA]:
        geqrt.ROWS_PER_CTA = rows_per_cta
        for name, (fn, (steps, rows, full_first)) in calls.items():
            plan = panel.pipeline_plan(nb, ib, steps, rows, full_first)
            # K2's serial loop is chain.cu's; the pipelined launches are
            # panel.cu's (tq_panel_pipe)
            serial_k2 = name == "panel_chain" and plan.stages == 1
            read = lib.tq_cl_stages_chain if serial_k2 else lib.tq_cl_stages_panel
            time_stages(name, fn, read, plan, out, args.reps, slots=min(plan.stages, CL_SLOTS))
    r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).cuda()
              for _ in range(2))
    for ctas in args.ttqrt_ctas or [None]:
        plan = ttqrt.ttqrt_plan(nb, ib) if ctas is None else ttqrt.ttqrt_plan_at(nb, ib, ctas)
        time_stages("ttqrt", lambda: ttqrt._launch_ttqrt(r1, r2, ib, plan), lib.tq_cl_stages_ttqrt,
                    plan, out, args.reps)


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


def time_stages(name, fn, read, plan, out, reps: int, stages=STAGES, slots: int = 1) -> None:
    """One call's time by CUDA events and its stages by the device timer:
    CTA 0's of the one cluster, or of each of ``slots`` stage clusters."""
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), name)
    ms = cuda_ms(fn, reps)
    _build.check(read(ctypes.addressof(out)), name)
    print(f"{name} {plan}: {ms:.3f} ms per call (CUDA events)")
    k = len(stages)
    busy = []
    for slot in range(slots):
        split = [out[slot * k + i] / 1e6 / reps for i in range(k)]
        busy.append(sum(split[:8]) if stages is STAGES else sum(split))
        print(f"  {'stage ' + str(slot) if slots > 1 else 'stages'} on CTA 0: " + ", ".join(
            f"{s} {t:.4f} ms ({t / max(sum(split), 1e-9):.1%})" for s, t in zip(stages, split)))
    if slots > 1:
        print(f"  busy (less the hand-off wait) by stage: " + ", ".join(
            f"{t:.4f} ms ({t / max(sum(busy), 1e-9):.1%})" for t in busy))


def time_cta_stages(name, fn, read, plan, stages, out, reps: int) -> None:
    """One call's time by CUDA events and every CTA's stages of its first
    cluster by the device timer."""
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), name)
    ms = cuda_ms(fn, reps)
    _build.check(read(ctypes.addressof(out)), name)
    print(f"{name} {plan}: {ms:.4f} ms per call (CUDA events)")
    k = len(stages)
    for r in range(plan.ctas):
        split = [out[r * k + i] / 1e6 / reps for i in range(k)]
        print(f"  CTA {r}: " + ", ".join(f"{s} {t:.4f} ms" for s, t in zip(stages, split)))


if __name__ == "__main__":
    raise SystemExit(main())

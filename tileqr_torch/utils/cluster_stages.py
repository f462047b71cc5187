"""Where K1 and K2's time goes, stage by stage, on the card.

    python -m tileqr_torch.utils.cluster_stages [--n 8192] [--reps 5]
        [--rows-per-cta 160 80]

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
default: the plan's own). Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from tileqr_torch.kernels import _build

STAGES = ("slab load/store", "P + reduction", "block T", "off-diagonal T", "apply",
          "column dots", "exchange + cluster barrier", "LARFG + rank-1 update")


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
    for name in ("tq_cl_stages_panel", "tq_cl_stages_chain"):
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_stages: needs a CUDA device")
        return 1
    from tileqr_torch.kernels import chain, panel

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
    return 0


def time_stages(name, fn, read, plan, out, reps: int) -> None:
    """One call's time by CUDA events and its stages by the device timer."""
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), name)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    _build.check(read(ctypes.addressof(out)), name)
    split = [v / 1e6 / reps for v in out]
    print(f"{name} {plan}: {ms:.3f} ms per call (CUDA events); "
          f"stages on CTA 0: " + ", ".join(
              f"{s} {t:.3f} ms ({t / max(sum(split), 1e-9):.1%})"
              for s, t in zip(STAGES, split)))


if __name__ == "__main__":
    raise SystemExit(main())

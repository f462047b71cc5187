"""B8 and TTQRT at each cluster size, on the card.

    python -m tileqr_torch.utils.plan_sweep [--reps 50] [--repeat 3]

B8 (``kernels/modlu.py``) on the top block of an orthonormal (4nb, nb)
factor at nb = 256 and 512, and TTQRT (``kernels/ttqrt.py``) on two upper-
triangular gaussian (256, 256) tiles at ib = 128, for every C of
``CLUSTER_SIZES`` (a resident plan, or the global-memory one where the
block does not fit). The wrappers always take their own plan
(``modlu_plan``, ``ttqrt_plan``); this tool builds the plan of each C
itself and calls the C functions directly. Each line: the plan, the
kernel's mean time over ``--reps`` warm launches (CUDA events), taken
``--repeat`` times, its relative Frobenius difference from the plain
version (and for B8 whether d is equal), beside the plan the wrappers
pick, the PyTorch call that computes the same function
(``lu_factor(Q_top − diag(d), pivot=False)``, ``torch.geqrf``) and, for
TTQRT, the tsqrt kernel (K2) on the same couple. The card's name and
power limit from nvidia-smi head the output. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import List, Tuple

import numpy as np
import torch

from tileqr_torch.kernels import _build
from tileqr_torch.kernels.modlu import (ModluPlan, modlu_panel_width, modlu_plan,
                                        modlu_smem_bytes, modified_lu_plain)
from tileqr_torch.kernels.panel import (CLUSTER_SIZES, SMEM_LIMIT, ClusterPlan, cluster_plan,
                                        cluster_smem_bytes, ttqrt_plan, ttqrt_rows)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps calls (CUDA
    events); the caller warms fn first."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def modlu_plan_at(nb: int, ctas: int) -> ModluPlan:
    """B8's plan on C = ``ctas`` CTAs: the block in their shared memory
    where it fits, else in global memory."""
    if nb < 1 or ctas not in CLUSTER_SIZES:
        raise ValueError(f"modlu_plan_at: nb={nb}, ctas={ctas}")
    resident = modlu_smem_bytes(nb, ctas, True) <= SMEM_LIMIT
    return ModluPlan(ctas, modlu_panel_width(nb, ctas), modlu_smem_bytes(nb, ctas, resident),
                     resident)


def ttqrt_plan_at(nb: int, ib: int, ctas: int) -> ClusterPlan:
    """TTQRT's plan on C = ``ctas`` CTAs: the active block in their shared
    memory where it fits, else in a global workspace."""
    if nb < 1 or not 1 <= ib <= nb or ctas not in CLUSTER_SIZES:
        raise ValueError(f"ttqrt_plan_at: nb={nb}, ib={ib}, ctas={ctas}")
    rows = ttqrt_rows(nb, ib)
    resident = cluster_smem_bytes(nb, rows, ib, ctas, True) <= SMEM_LIMIT
    return ClusterPlan(ctas, cluster_smem_bytes(nb, rows, ib, ctas, resident), resident,
                       -(-rows // ctas))


def modlu_at(q_top: torch.Tensor, plan: ModluPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One B8 launch on a contiguous CUDA block at ``plan``: (lu, d)."""
    n = q_top.shape[0]
    lu, d = torch.empty_like(q_top), q_top.new_empty(n)
    _build.check(_build.lib().tq_modified_lu(q_top.data_ptr(), lu.data_ptr(), n, d.data_ptr(),
                                             plan.ctas, plan.smem_bytes, int(plan.resident),
                                             _build.stream()), "modified_lu")
    return lu, d


def ttqrt_at(r1: torch.Tensor, r2: torch.Tensor, ib: int,
             plan: ClusterPlan) -> Tuple[torch.Tensor, ...]:
    """One TTQRT launch on contiguous CUDA tiles at ``plan``: (R, V2, T2)."""
    nb = r1.shape[0]
    r, v2, t2 = (torch.empty_like(r1) for _ in range(3))
    lib = _build.lib()
    work = r1.new_empty(lib.tq_cluster_work_floats(nb, ttqrt_rows(nb, ib), ib, plan.ctas,
                                                   int(plan.resident)))
    _build.check(lib.tq_ttqrt(r1.data_ptr(), r2.data_ptr(), nb, ib, r.data_ptr(), v2.data_ptr(),
                              t2.data_ptr(), work.data_ptr(), plan.ctas, plan.smem_bytes,
                              int(plan.resident), _build.stream()), "ttqrt")
    return r, v2, t2


def rel(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(torch.linalg.norm((x - y).double()) / torch.linalg.norm(y.double()))


def timed(fn, reps: int, repeat: int) -> List[float]:
    fn()
    torch.cuda.synchronize()
    return [cuda_ms(fn, reps) for _ in range(repeat)]


def fmt(ms: List[float]) -> str:
    return "/".join(f"{t:.4f}" for t in ms) + " ms"


def sweep_modlu(nb: int, reps: int, repeat: int) -> None:
    q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(nb).standard_normal(
        (4 * nb, nb))).cuda())
    q_top = q[:nb].float().contiguous()
    lu_p, d_p = modified_lu_plain(q_top)
    shifted = q_top - torch.diag(d_p)
    lib = timed(lambda: torch.linalg.lu_factor(shifted, pivot=False), reps, repeat)
    print(f"B8 nb={nb}: the wrappers' plan {modlu_plan(nb)}; "
          f"lu_factor(pivot=False) {fmt(lib)}")
    for c in CLUSTER_SIZES:
        plan = modlu_plan_at(nb, c)
        lu, d = modlu_at(q_top, plan)
        ms = timed(lambda: modlu_at(q_top, plan), reps, repeat)
        print(f"B8 nb={nb} {plan}: {fmt(ms)}, rel {rel(lu, lu_p):.3e}, "
              f"d equal {torch.equal(d, d_p)}")


def sweep_ttqrt(nb: int, ib: int, reps: int, repeat: int) -> None:
    from tileqr_torch.kernels import tsqrt, ttqrt

    rng = np.random.default_rng(nb + ib)
    r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).cuda()
              for _ in range(2))
    want = ttqrt.ttqrt_plain(r1, r2, ib)
    couple = torch.cat([r1, r2])
    geqrf = timed(lambda: torch.geqrf(couple), reps, repeat)
    k2 = timed(lambda: tsqrt.tsqrt(r1, r2, ib), reps, repeat)
    print(f"TTQRT nb={nb} ib={ib}: the wrappers' plan {ttqrt_plan(nb, ib)}; tsqrt "
          f"kernel (K2, {cluster_plan(nb, 2 * nb, ib)}) {fmt(k2)}, torch.geqrf {fmt(geqrf)}")
    for c in CLUSTER_SIZES:
        plan = ttqrt_plan_at(nb, ib, c)
        got = ttqrt_at(r1, r2, ib, plan)
        ms = timed(lambda: ttqrt_at(r1, r2, ib, plan), reps, repeat)
        print(f"TTQRT nb={nb} ib={ib} {plan}: {fmt(ms)}, "
              f"rel {max(rel(g, w) for g, w in zip(got, want)):.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_sweep: needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    for nb in (256, 512):
        sweep_modlu(nb, args.reps, args.repeat)
    sweep_ttqrt(256, 128, args.reps, args.repeat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

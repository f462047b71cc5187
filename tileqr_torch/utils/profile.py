"""Device time per CUDA kernel of one factorization, by torch.profiler.

    python -m tileqr_torch.utils.profile --n 16384 --method hr [--qr] [--health]
    python -m tileqr_torch.utils.profile --method hh --n 8192 --precision b3
    python -m tileqr_torch.utils.profile --method tsqr [--n 512] [--qr]
    python -m tileqr_torch.utils.profile --method batched [--n 128]
    python -m tileqr_torch.utils.profile --method sharded [--n 16384]

Builds the kernels, runs ``qr_factor`` (or, with ``--qr``, ``qr``) once
warm on a gaussian fp32 (n, n) A made from ``--seed``, then once more under
``torch.profiler``; ``--method tsqr`` profiles ``tsqr(a, "r")`` (with
``--qr``: "reduced") on a (1048576, n) A with ``QRConfig(nb=n)``, and
``--method batched`` ``qr_batched`` (Q and R) on a (4096, n, n) stack:
BASELINE's configs 3 and 4 at the default n. ``--method sharded`` spawns
a 4×2 world of ranks on the machine's cards (``dist/launch.py``) and
profiles ``qr_sharded(mode="factor")`` on every rank: rank 0's kernels in
the tables, and each rank's device and wall time, whose device times add
up to the card's busy time when the ranks share one card. ``--precision`` sets
``QRConfig.precision`` (default "highest"); the square paths' update and
apply kernels then run that mode's instantiation (a template argument of
1, 3 or 4 bf16 passes in the kernel's name).
It prints the device time of every CUDA kernel name
(launches, total ms, share of the device total), the same summed over
groups (this package's kernels by name, cuBLAS GEMMs as "torch.matmul",
everything else as "other torch ops"), the wall time of the profiled call
and the device's idle share of it. With ``--health`` (hr only) it also prints
each panel's round-1 orthogonality defect, whose max is the hr health.
The card's name and power limit from nvidia-smi head the output. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

# CUDA kernel name fragments of this package's kernels (csrc/*.cu)
OWN = {
    "panel_factor_kernel": "panel_factor",
    "panel_chain_kernel": "panel_chain",
    "couple_strip_kernel": "couple_strip",
    "larfb_strip_kernel": "larfb_strip",
    "modlu_kernel": "modified_lu",
    "potrf_kernel": "potrf_batched",
    "project_kernel": "panel apply B6/B7 (phase 1)",
    "apply_kernel": "panel apply B6/B7 (phase 2)",
    "project_bx_kernel": "panel apply B6/B7 (phase 1, split product)",
    "sub_bx_kernel": "panel apply B6/B7 (phase 2, split product)",
    "geqrt_batched_kernel": "geqrt_batched",
    "ttqrt_kernel": "ttqrt",
}


def group_of(name: str) -> str:
    for frag, g in OWN.items():
        if frag in name:
            return g
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name.lower():
        return "torch.matmul (cuBLAS)"
    return "other torch ops"


def kernel_times(prof) -> dict:
    """{kernel name: (launches, device ms)} from the profiler's events."""
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rec = out[e.name]
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e3
    return {k: tuple(v) for k, v in out.items()}


def panel_health(a: torch.Tensor, cfg) -> list:
    """Each panel's round-1 defect over the hr driver's panel loop on A
    (``square_hr.hr_steps``), unscaled: prescaling by a power of two
    changes no defect."""
    from tileqr_torch.drivers import square_hr

    ap, _ = square_hr.pad_for_hr(a, cfg.nb)
    return [float(h) for _, _, h in square_hr.hr_steps(ap, cfg.nb, stats=True)]


def profile_call(args, shape, n: int, tileqr_torch):
    """One warm call of the method on a gaussian A, then one under
    torch.profiler: (kernel times, wall ms)."""
    rng = np.random.default_rng(args.seed)
    a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    if args.method == "tsqr":
        cfg = tileqr_torch.QRConfig(nb=n, precision=args.precision)
    else:
        cfg = tileqr_torch.QRConfig(square_method="hr" if args.method == "hr" else "hh",
                                    precision=args.precision)

    def call():
        if args.method == "tsqr":
            return tileqr_torch.tsqr(a, "reduced" if args.qr else "r", cfg)
        if args.method == "batched":
            return tileqr_torch.qr_batched(a, config=cfg)
        if args.qr:
            return tileqr_torch.qr(a, config=cfg)
        return tileqr_torch.qr_factor(a, cfg)

    call()  # warm: build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    return kernel_times(prof), wall_ms


def sharded_rank(mesh, n: int, seed: int, precision: str):
    """``--method sharded`` on every rank: one warm factor, then one more
    between barriers under torch.profiler. Returns, on rank 0, rank 0's
    (kernel times, wall ms) and every rank's (device ms, wall ms)."""
    import torch.distributed as dist

    import tileqr_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).cuda()
    cfg = tileqr_torch.QRConfig(mesh_shape=mesh.shape, precision=precision)
    tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")
    torch.cuda.synchronize()
    dist.barrier()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kt = kernel_times(prof)
    totals = [None] * dist.get_world_size()
    dist.all_gather_object(totals, (sum(ms for _, ms in kt.values()), wall_ms))
    return (kt, wall_ms, totals) if mesh.rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="columns (default 16384 square, 512 tsqr, 128 batched)")
    ap.add_argument("--method", choices=("hh", "hr", "tsqr", "batched", "sharded"),
                    default="hr")
    ap.add_argument("--qr", action="store_true", help="profile qr (factor + R + Q)")
    ap.add_argument("--health", action="store_true", help="hr: print each panel's defect")
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "b3", "b4", "high", "default"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")

    import tileqr_torch
    from tileqr_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    _build.lib()
    n = args.n or {"tsqr": 512, "batched": 128}.get(args.method, 16384)
    shape = {"tsqr": (1048576, n), "batched": (4096, n, n)}.get(args.method, (n, n))
    what = {"tsqr": "tsqr reduced" if args.qr else "tsqr r", "batched": "qr_batched",
            "sharded": "qr_sharded factor, rank 0 of 4x2 ranks"}.get(
        args.method, f"{args.method} {'qr' if args.qr else 'qr_factor'}")
    what += f" precision={args.precision}"
    if args.method == "sharded":
        from tileqr_torch.dist import launch

        kt, wall_ms, totals = launch.run_world(sharded_rank, 4, 2, device="cuda", kwargs=dict(
            n=n, seed=args.seed, precision=args.precision))
        kt = {k: tuple(v) for k, v in kt.items()}
    else:
        kt, wall_ms = profile_call(args, shape, n, tileqr_torch)
    total = sum(ms for _, ms in kt.values())
    print(f"{what} {'x'.join(map(str, shape))}: wall {wall_ms:.3f} ms under the profiler, "
          f"device total {total:.3f} ms, idle share {max(0.0, 1 - total / wall_ms):.4f}"
          f"{' (of rank 0 alone)' if args.method == 'sharded' else ''} [{card}]")
    if args.method == "sharded":
        # ranks sharing one card time-slice it (no MPS): where their kernels
        # never overlap, the sum of their device times is the card's busy
        # time; a sum above the wall means the recorded spans overlap
        busy, wall = sum(d for d, _ in totals), max(w for _, w in totals)
        print("per rank (device ms, wall ms): "
              + ", ".join(f"({d:.3f}, {w:.3f})" for d, w in totals)
              + f"; all ranks' device time {busy:.3f} ms, {busy / wall:.4f} of the longest "
              f"wall {wall:.3f} ms [{card}]")
    groups = defaultdict(lambda: [0, 0.0])
    for name, (cnt, ms) in kt.items():
        g = groups[group_of(name)]
        g[0] += cnt
        g[1] += ms
    print("group | launches | device ms | share")
    for g, (cnt, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"{g} | {cnt} | {ms:.3f} | {ms / max(total, 1e-9):.4f}")
    print("kernel | launches | device ms | share")
    for name, (cnt, ms) in sorted(kt.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"{name[:110]} | {cnt} | {ms:.3f} | {ms / max(total, 1e-9):.4f}")
    if args.health and args.method == "hr":
        a = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
            shape, dtype=np.float32)).cuda()
        cfg = tileqr_torch.QRConfig(square_method="hr", precision=args.precision)
        hs = panel_health(a, cfg)
        top = sorted(range(len(hs)), key=lambda k: -hs[k])[:6]
        print(f"hr panel health (round-1 defect) over {len(hs)} panels: max {max(hs):.3e} at "
              f"panel {top[0]}, median {float(np.median(hs)):.3e}; largest: "
              + ", ".join(f"panel {k} ({n - k * cfg.nb} rows) {hs[k]:.3e}" for k in top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

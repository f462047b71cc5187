"""Device time per CUDA kernel of one factorization, by torch.profiler.

    python -m tileqr_torch.utils.profile --n 16384 --method hr [--qr] [--health]
    python -m tileqr_torch.utils.profile --method hh --n 8192 --precision b3
    python -m tileqr_torch.utils.profile --method tsqr [--n 512] [--qr]
    python -m tileqr_torch.utils.profile --method batched [--n 128]
    python -m tileqr_torch.utils.profile --method batched_cholqr2 [--n 128]
    python -m tileqr_torch.utils.profile --method sharded [--n 16384]
    python -m tileqr_torch.utils.profile --method sharded_hr [--n 16384] [--precision b3]

Builds the kernels, runs ``qr_factor`` (or, with ``--qr``, ``qr``) once
warm on a gaussian fp32 (n, n) A made from ``--seed``, then once more under
``torch.profiler``; ``--method tsqr`` profiles ``tsqr(a, "r")`` (with
``--qr``: "reduced") on a (1048576, n) A with ``QRConfig(nb=n)``, and
``--method batched`` ``qr_batched`` (Q and R) on a (4096, n, n) stack:
BASELINE's configs 3 and 4 at the default n; ``--method batched_cholqr2``
the same with ``batched_method="cholqr2"`` on G + 4·√n·I (well
conditioned, so the guard does not fall back). ``--method sharded`` spawns
a 4×2 world of ranks on the machine's cards (``dist/launch.py``) and
profiles ``qr_sharded(mode="factor")`` on every rank: rank 0's kernels in
the tables, and each rank's device and wall time, whose device times add
up to the card's busy time when the ranks share one card; ``--method
sharded_hr`` the same with square_method="hr" (the CholeskyQR2 sharded
driver). ``--precision`` sets
``QRConfig.precision`` (default "highest"); the square paths' update and
apply kernels then run that mode's instantiation (a template argument of
1, 3 or 4 bf16 passes in the kernel's name).
It prints the device time of every CUDA kernel name
(launches, total ms, share of the device total), the same summed over
groups (this package's kernels by name, cuBLAS GEMMs as "torch.matmul",
everything else as "other torch ops"), the wall time of the profiled call
and the device's idle share of it, then the device time inside each of
the program's spans (``span_times``) and the host's, and how many of the
profiled call's K1/K2 launches ran pipelined by ib block, with their couple
steps that overlapped (``_build.PIPELINE``), the cluster routine's launches
on clusters of more than one CTA with the columns whose partials they
exchanged (``_build.EXCHANGE``), K3's launches by plan with the couples
they swept (``_build.STRIP``) and by the chain's row bands
(``_build.CHAIN``), the hh driver's updates split for its
lookahead and its panels launched beside a rest update
(``core/trace.py:LOOKAHEAD``), the CholeskyQR guard's
checks and trips by call site (``core/trace.py:GUARD``), and the hr
square path's block-reflector applies by route
(``core/trace.py:HR_APPLY``), and B6's and B7's fp32 phase-1 launches by
schedule, balanced or on the whole-tile grid, with the chains handed
between blocks (``_build.PROJECT``). ``--group G``
prints the device ms of G's kernels alone inside each span, and inside the
narrow hh updates (``narrow_updates``). With ``--health`` (hr
only) it also prints each panel's round-1 orthogonality defect, whose max
is the hr health.
The card's name and power limit from nvidia-smi head the output. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import subprocess
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

# CUDA kernel name fragments of this package's kernels (csrc/*.cu), matched
# before the cuBLAS test below, so that no kernel of ours is filed as a GEMM
OWN = {
    "panel_factor_kernel": "panel_factor",
    "panel_chain_kernel": "panel_chain",
    "proj_f32_kernel": "couple_strip (K3 stage 1, projections)",
    "proj_wg_kernel": "couple_strip (K3 stage 1, projections, split product)",
    "chain_kernel": "couple_strip/larfb_strip (K3 stage 2 and K4, the chain)",
    "modlu_kernel": "modified_lu",
    "potrf_cluster_kernel": "potrf_batched",
    "project_f32_kernel": "panel apply B6/B7/B7a (phase 1)",
    "project_wg_kernel": "panel apply B6/B7/B7a (phase 1, split product)",
    "combine_kernel": "panel apply B6/B7 (phase 1's groups combined, op(T) folded in)",
    "sub_f32_kernel": "C -= Y W: B6/B7/B7b phase 2 and K3 stage 3",
    "sub_wg_kernel": "C -= Y W: B6/B7/B7b phase 2 and K3 stage 3 (split product)",
    "geqrt_batched_kernel": "geqrt_batched",
    "geqrt_cluster_kernel": "geqrt_batched (cluster route)",
    "geqrt_small_kernel": "geqrt_batched (small route)",
    "geqrt_tall_kernel": "geqrt_batched (tall route)",
    "Memcpy": "copies (Memcpy)",
    "ttqrt_kernel": "ttqrt",
}


# the program's spans (``core/trace.py``)
SPAN_PREFIX = "tileqr_torch."


def group_of(name: str) -> str:
    for frag, g in OWN.items():
        if frag in name:
            return g
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name.lower():
        return "torch.matmul (cuBLAS)"
    return "other torch ops"


def kernel_times(prof) -> dict:
    """{kernel name: (launches, device ms)} from the profiler's events: the
    device operations, without the spans' annotations on the device's
    timeline."""
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
            continue
        rec = out[e.name]
        rec[0] += 1
        rec[1] += (e.time_range.end - e.time_range.start) / 1e3
    return {k: tuple(v) for k, v in out.items()}


def _nest(spans: list) -> list:
    """The parent index of each span of a list sorted by (start, -end),
    nesting by time (one that starts as another ends follows it): None
    where no span holds it."""
    parent, open_ = [], []
    for i, (s, e, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] <= s:
            open_.pop()
        parent.append(open_[-1] if open_ else None)
        open_.append(i)
    return parent


def span_times(events, group: Optional[str] = None) -> dict:
    """Device and host time of the program's spans (``core/trace.py``) in a
    torch.profiler trace of whole calls made on one host thread, in
    seconds. Each device operation is charged to the spans that were open
    when the host launched it: its runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) carries the same correlation id, and the
    launch time decides, not the device time, since the device runs up to
    a call behind the host. "inclusive" {name: s} counts an operation once
    for each name open around its launch, "exclusive" {name: s} for the
    innermost alone, "unattributed" the operations launched outside every
    span (or whose launch the trace lacks); "device" is all of them. On
    the host: "calls", the outermost spans; "host_s", their time; "syncs"
    and "sync_s", the ``sync.*`` spans. ``group``: count only the device
    operations that ``group_of`` files under it (e.g. K3's chain)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans, launch, ops = [], {}, []
    for e in events:
        if e.device_type == cpu and e.name.startswith(SPAN_PREFIX):
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == cpu and e.name.startswith("cu"):  # the runtime's calls
            launch[e.id] = e.time_range.start
        elif (e.device_type == cuda and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith((SPAN_PREFIX, "qrbench."))
              and (group is None or group_of(e.name) == group)):
            ops.append((e.id, (e.time_range.end - e.time_range.start) / 1e6))
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    parent = _nest(spans)
    starts = [sp[0] for sp in spans]
    inclusive, exclusive = defaultdict(float), defaultdict(float)
    unattributed = 0.0
    for cid, sec in ops:
        t = launch.get(cid)
        j = None if t is None else bisect.bisect_right(starts, t) - 1
        while j is not None and j >= 0 and spans[j][1] < t:
            j = parent[j]
        if j is None or j < 0:
            unattributed += sec
            continue
        exclusive[spans[j][2]] += sec
        names = set()
        while j is not None:
            names.add(spans[j][2])
            j = parent[j]
        for name in names:
            inclusive[name] += sec
    outer = [sp for sp, p in zip(spans, parent) if p is None]
    syncs = [sp for sp in spans if sp[2].startswith(SPAN_PREFIX + "sync.")]
    return {"inclusive": dict(inclusive), "exclusive": dict(exclusive),
            "unattributed": unattributed, "device": sum(sec for _, sec in ops),
            "calls": len(outer), "host_s": sum(e - s for s, e, _ in outer) / 1e6,
            "syncs": len(syncs), "sync_s": sum(e - s for s, e, _ in syncs) / 1e6}


def narrow_updates(events) -> list:
    """The events without the hh driver's rest updates: an
    ``hh.update`` span is a narrow update (column tile k+1, or the last
    update, which is one tile) where the next ``hh.panel`` or ``hh.update``
    span to start is a panel's (``drivers/square.py:qr_tiled`` runs narrow
    k, panel k+1, rest k). ``span_times`` of what is left charges the rest
    updates' operations to the spans around them, so its ``hh.update`` is
    the narrow updates'."""
    cpu = torch.autograd.DeviceType.CPU
    hh = (SPAN_PREFIX + "hh.panel", SPAN_PREFIX + "hh.update")
    marks = sorted((e.time_range.start, i) for i, e in enumerate(events)
                   if e.device_type == cpu and e.name in hh)
    rest = {i for (_, i), nxt in zip(marks, marks[1:] + [None])
            if events[i].name == hh[1] and (nxt is None or events[nxt[1]].name != hh[0])}
    return [e for i, e in enumerate(events) if i not in rest]


def panel_health(a: torch.Tensor, cfg) -> list:
    """Each panel's round-1 defect over the hr driver's panel loop on A
    (``square_hr.hr_steps``), unscaled: prescaling by a power of two
    changes no defect."""
    from tileqr_torch.drivers import square_hr

    ap, _ = square_hr.pad_for_hr(a, cfg.nb)
    return [float(h) for _, _, h in square_hr.hr_steps(ap, cfg.nb, stats=True)]


def profile_call(args, shape, n: int, tileqr_torch):
    """One warm call of the method on a gaussian A, then one under
    torch.profiler: (kernel times, wall ms, the profiler's events)."""
    rng = np.random.default_rng(args.seed)
    a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    if args.method == "tsqr":
        cfg = tileqr_torch.QRConfig(nb=n, precision=args.precision)
    elif args.method == "batched_cholqr2":
        a += 4 * float(np.sqrt(n)) * torch.eye(n, device=a.device)
        cfg = tileqr_torch.QRConfig(batched_method="cholqr2", precision=args.precision)
    else:
        cfg = tileqr_torch.QRConfig(square_method="hr" if args.method == "hr" else "hh",
                                    precision=args.precision)

    def call():
        if args.method == "tsqr":
            return tileqr_torch.tsqr(a, "reduced" if args.qr else "r", cfg)
        if args.method.startswith("batched"):
            return tileqr_torch.qr_batched(a, config=cfg)
        if args.qr:
            return tileqr_torch.qr(a, config=cfg)
        return tileqr_torch.qr_factor(a, cfg)

    from tileqr_torch.kernels import _build

    call()  # warm: build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    _build.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    return kernel_times(prof), wall_ms, prof.events()


def sharded_rank(mesh, n: int, seed: int, precision: str, method: str = "hh"):
    """``--method sharded`` (or ``sharded_hr``: ``method`` "hr") on every
    rank: one warm factor, then one more between barriers under
    torch.profiler. Returns, on rank 0, rank 0's (kernel times, wall ms)
    and every rank's (device ms, wall ms)."""
    import torch.distributed as dist

    import tileqr_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).cuda()
    cfg = tileqr_torch.QRConfig(mesh_shape=mesh.shape, precision=precision,
                                square_method=method)
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
    ap.add_argument("--method", choices=("hh", "hr", "tsqr", "batched", "batched_cholqr2",
                                         "sharded", "sharded_hr"), default="hr")
    ap.add_argument("--qr", action="store_true", help="profile qr (factor + R + Q)")
    ap.add_argument("--health", action="store_true", help="hr: print each panel's defect")
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "b3", "b4", "high", "default"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group", nargs="*", default=[],
                    help="kernel groups (group_of) whose device ms inside each span to print")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")

    import tileqr_torch
    from tileqr_torch.core import trace
    from tileqr_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    _build.lib()
    n = args.n or {"tsqr": 512, "batched": 128, "batched_cholqr2": 128}.get(args.method, 16384)
    shape = {"tsqr": (1048576, n), "batched": (4096, n, n),
             "batched_cholqr2": (4096, n, n)}.get(args.method, (n, n))
    what = {"tsqr": "tsqr reduced" if args.qr else "tsqr r", "batched": "qr_batched",
            "batched_cholqr2": "qr_batched cholqr2 (G + 4 sqrt(n) I)",
            "sharded": "qr_sharded factor, rank 0 of 4x2 ranks",
            "sharded_hr": "qr_sharded hr factor, rank 0 of 4x2 ranks"}.get(
        args.method, f"{args.method} {'qr' if args.qr else 'qr_factor'}")
    what += f" precision={args.precision}"
    sharded = args.method.startswith("sharded")
    if sharded:
        from tileqr_torch.dist import launch

        kt, wall_ms, totals = launch.run_world(sharded_rank, 4, 2, device="cuda", kwargs=dict(
            n=n, seed=args.seed, precision=args.precision,
            method="hr" if args.method == "sharded_hr" else "hh"))
        kt = {k: tuple(v) for k, v in kt.items()}
        spans = events = None
    else:
        kt, wall_ms, events = profile_call(args, shape, n, tileqr_torch)
        spans = span_times(events)
    total = sum(ms for _, ms in kt.values())
    if not sharded:
        k1 = _build.LAUNCHES["panel_factor"] + _build.LAUNCHES["panel_chain"]
        print(f"K1/K2 launches pipelined by ib block: {_build.PIPELINE['launches']} of {k1}; "
              f"couple steps overlapped: {_build.PIPELINE['overlapped_steps']}")
        print(f"cluster-routine launches exchanging partials by st.async: "
              f"{_build.EXCHANGE['launches']}, columns exchanged: {_build.EXCHANGE['columns']}")
        print("K3 launches by plan (stage-1 tile, G, stage-3 tile): launches, couples: "
              + ("; ".join(f"{p[0][0]}x{p[0][1]}, G={p[1]}, {p[2][0]}x{p[2][1]}: "
                           f"{e['launches']}, {e['couples']}"
                           for p, e in sorted(_build.STRIP.items())) or "none"))
        # (a checkout from before the counter has none)
        print("K3 chain launches by row bands a block: launches, couples: "
              + ("; ".join(f"{b}: {e['launches']}, {e['couples']}"
                           for b, e in sorted(getattr(_build, "CHAIN", {}).items())) or "none"))
        print(f"hh lookahead: updates split {trace.LOOKAHEAD['split']}, panel launches beside "
              f"a rest update {trace.LOOKAHEAD['beside']} of {_build.LAUNCHES['panel_factor']}")
        print(f"CholeskyQR guard checks and trips by site: {trace.GUARD or 'none'}")
        print(f"hr applies by route: {trace.HR_APPLY}")
        print(f"fp32 phase-1 launches by schedule: balanced {_build.PROJECT['balanced']}, "
              f"whole tiles {_build.PROJECT['whole_tiles']}, chains handed "
              f"{_build.PROJECT['handed']}")
    print(f"{what} {'x'.join(map(str, shape))}: wall {wall_ms:.3f} ms under the profiler, "
          f"device total {total:.3f} ms, idle share {max(0.0, 1 - total / wall_ms):.4f}"
          f"{' (of rank 0 alone)' if sharded else ''} [{card}]")
    if sharded:
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
    if spans:
        print(f"span | device ms inside | device ms innermost "
              f"(unattributed {spans['unattributed'] * 1e3:.3f}); host ms "
              f"{spans['host_s'] * 1e3:.3f}, {spans['syncs']} syncs "
              f"{spans['sync_s'] * 1e3:.3f} ms")
        for name, sec in sorted(spans["inclusive"].items(), key=lambda kv: -kv[1]):
            print(f"{name} | {sec * 1e3:.3f} | {spans['exclusive'].get(name, 0.0) * 1e3:.3f}")
        for g in args.group:
            inc = span_times(events, g)["inclusive"]
            narrow = span_times(narrow_updates(events), g)["inclusive"]
            print(f"group {g!r}, device ms inside each span: "
                  + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in sorted(inc.items()))
                  + f"; narrow hh.update {narrow.get(SPAN_PREFIX + 'hh.update', 0.0) * 1e3:.3f}")
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

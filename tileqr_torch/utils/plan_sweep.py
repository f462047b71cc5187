"""Launch plans at each size they can take, on the card: B8, B9 and TTQRT
at each cluster size, the batched GEQRT at each cluster size, its small
route at each CTA size and its tall route at each panel width, and the
whole-panel projection at each number of row-block groups.

    python -m tileqr_torch.utils.plan_sweep [--reps 50] [--repeat 3] [--only NAME ...]

B9 (``kernels/potrf.py``, ``--only potrf``) on the gram of a gaussian
(2n, n) at (1, 256), (1, 512) and (4096, 128), at every C with b·C within
the card (its blocks resident where they fit), beside ``potrf_plan``'s C
and ``torch.linalg.cholesky``; its outputs must be bitwise equal at every
C. The small route (``--only small``) on qr_batched's 4096 × 128² at ib 32
and 128 at 128, 256 and 512 threads a CTA (with the CTAs an SM holds),
and the stacks that both it and the cluster route take (m >= n, b·C
within the card) on both, the routes side by side, beside the plan
``batched_plan`` picks. The tall route (``--only tall``) on the tsqr
leaves (512 × 2048×512), the tree's level 1 (128 × 2048×512), qr_batched's
4096 × 256² and a 140 × 256² stack at ib 128, at every panel width w the
kernel is built for (a CTA a leaf, one an SM), beside
``tall_plan``'s pick, the one-block kernel and ``torch.geqrf``.

B8 (``kernels/modlu.py``) on the top block of an orthonormal (4nb, nb)
factor at nb = 256 and 512, and TTQRT (``kernels/ttqrt.py``) on two upper-
triangular gaussian (256, 256) tiles at ib = 128, for every C of
``CLUSTER_SIZES`` (a resident plan, or the global-memory one where the
block does not fit). The batched GEQRT (``kernels/geqrt.py``) on a
gaussian 256² tile (B1s) and on the tsqr tree's 2048 × 512 stacks of 32,
8, 2 and 1 matrices (1048576 × 512 at nb = 512, ib = 128): the one-block
kernel (C = 1) and the cluster route at every C with b·C within the card,
beside the plan ``batched_cluster_plan`` picks. The projection
(``kernels/panel_apply.py``: phase 1 of B6/B7, and B7a) in each mode at
every G that divides its row blocks evenly (the tile is fixed by each
mode's build: 128 × 128 in fp32, 128 × 64 in the split modes), beside
``project_plan``'s G: B7a at the sharded hr path's slice (Y 4096 × 256, C
4096 × 8192), B6 panels 0 and 48 of 16384² with op(T) folded in, and the
tsqr cholqr2 factor's B7 at nb = 512 in b3 (Y 1048576 × 512, C the same).
The wrappers always take their own plan; this tool takes each kernel's
plan at each size from its module (``modlu_plan_at``, ``ttqrt_plan_at``,
``potrf_plan_at``, ``batched_cluster_plan_at``, ``tall_plan_at``,
``project_plan_at``, ``strip_plan_at``: the rule the wrappers' choosers
call) and launches it through the module's launcher, the one the wrappers
call. Each line: the plan,
the kernel's mean time over ``--reps`` warm launches (CUDA events), taken
``--repeat`` times, its relative Frobenius difference from the plain
version (for the projection: at the same G), beside the plan the
wrappers pick, the PyTorch call that computes the same function
(``lu_factor(Q_top − diag(d), pivot=False)``, ``torch.geqrf``, fp32
``torch.matmul``) and, for TTQRT, the tsqrt kernel (K2) on the same
couple. The card's name and power limit from nvidia-smi head the output.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import List, Tuple

import numpy as np
import torch

from tileqr_torch.kernels import _build, chain, geqrt, modlu, panel_apply, potrf, ttqrt
from tileqr_torch.kernels._build import CLUSTER_SIZES


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


def rel(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(torch.linalg.norm((x - y).double()) / torch.linalg.norm(y.double()))


def timed(fn, reps: int, repeat: int) -> List[float]:
    fn()
    torch.cuda.synchronize()
    return [cuda_ms(fn, reps) for _ in range(repeat)]


def fmt(ms: List[float]) -> str:
    return "/".join(f"{t:.4f}" for t in ms) + " ms"


def cluster_route(a: torch.Tensor, plan: geqrt.BatchedClusterPlan) -> Tuple[torch.Tensor, ...]:
    """The batched GEQRT at ``plan``: the one-block kernel at C = 1, else
    the cluster route."""
    return geqrt._geqrt_one_block(a, plan.ib) if plan.ctas == 1 else geqrt._geqrt_cluster(a, plan)


def sweep_modlu(nb: int, reps: int, repeat: int) -> None:
    q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(nb).standard_normal(
        (4 * nb, nb))).cuda())
    q_top = q[:nb].float().contiguous()
    lu_p, d_p = modlu.modified_lu_plain(q_top)
    shifted = q_top - torch.diag(d_p)
    lib = timed(lambda: torch.linalg.lu_factor(shifted, pivot=False), reps, repeat)
    print(f"B8 nb={nb}: the wrappers' plan {modlu.modlu_plan(nb)}; "
          f"lu_factor(pivot=False) {fmt(lib)}")
    for c in CLUSTER_SIZES:
        plan = modlu.modlu_plan_at(nb, c)
        lu, d = modlu._launch_modlu(q_top, plan)
        ms = timed(lambda: modlu._launch_modlu(q_top, plan), reps, repeat)
        print(f"B8 nb={nb} {plan}: {fmt(ms)}, rel {rel(lu, lu_p):.3e}, "
              f"d equal {torch.equal(d, d_p)}")


def sweep_ttqrt(nb: int, ib: int, reps: int, repeat: int) -> None:
    from tileqr_torch.kernels import tsqrt

    rng = np.random.default_rng(nb + ib)
    r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).cuda()
              for _ in range(2))
    want = ttqrt.ttqrt_plain(r1, r2, ib)
    couple = torch.cat([r1, r2])
    geqrf = timed(lambda: torch.geqrf(couple), reps, repeat)
    k2 = timed(lambda: tsqrt.tsqrt(r1, r2, ib), reps, repeat)
    print(f"TTQRT nb={nb} ib={ib}: the wrappers' plan {ttqrt.ttqrt_plan(nb, ib)}; tsqrt "
          f"kernel (K2, {geqrt.cluster_plan(nb, 2 * nb, ib)}) {fmt(k2)}, "
          f"torch.geqrf {fmt(geqrf)}")
    for c in CLUSTER_SIZES:
        plan = ttqrt.ttqrt_plan_at(nb, ib, c)
        got = ttqrt._launch_ttqrt(r1, r2, ib, plan)
        ms = timed(lambda: ttqrt._launch_ttqrt(r1, r2, ib, plan), reps, repeat)
        print(f"TTQRT nb={nb} ib={ib} {plan}: {fmt(ms)}, "
              f"rel {max(rel(g, w) for g, w in zip(got, want)):.3e}")


def sweep_geqrt(b: int, m: int, n: int, ib: int, reps: int, repeat: int) -> None:
    a = torch.from_numpy(np.random.default_rng(b + m).standard_normal(
        (b, m, n), dtype=np.float32)).cuda()
    want = geqrt.geqrt_batched_plain(a, ib)
    sms = _build.sm_count(a)
    lib = timed(lambda: torch.geqrf(a), max(1, reps // 5), repeat)
    print(f"geqrt_batched ({b}, {m}, {n}) ib={ib}: the wrappers' plan "
          f"{geqrt.batched_cluster_plan(b, m, n, ib, sms)}; torch.geqrf {fmt(lib)}")
    for c in CLUSTER_SIZES:
        if b * c > sms:
            continue
        plan = geqrt.batched_cluster_plan_at(m, n, ib, c)
        got = cluster_route(a, plan)
        ms = timed(lambda: cluster_route(a, plan), max(1, reps // 5), repeat)
        print(f"geqrt_batched ({b}, {m}, {n}) C={c}: {fmt(ms)}, "
              f"rel {max(rel(g, w) for g, w in zip(got, want)):.3e}")
    del a, want
    torch.cuda.empty_cache()


def sweep_potrf(b: int, n: int, reps: int, repeat: int) -> None:
    x = torch.from_numpy(np.random.default_rng(b + n).standard_normal(
        (b, 2 * n, n), dtype=np.float32)).cuda()
    g = x.transpose(1, 2) @ x
    del x
    sms = _build.sm_count(g)
    want = potrf.potrf_batched_plain(g)
    lib = timed(lambda: torch.linalg.cholesky(g, upper=True), reps, repeat)
    ref = potrf.potrf_batched(g)
    print(f"B9 ({b}, {n}, {n}): the wrappers' plan {potrf.potrf_plan(b, n, sms)}; "
          f"torch.linalg.cholesky {fmt(lib)}")
    for c in CLUSTER_SIZES:
        if c > 1 and b * c > sms:
            continue
        plan = potrf.potrf_plan_at(b, n, c)
        got = potrf._launch_potrf(g, 16, plan)
        ms = timed(lambda: potrf._launch_potrf(g, 16, plan), reps, repeat)
        print(f"B9 ({b}, {n}, {n}) {plan}: {fmt(ms)}, rel {rel(got, want):.3e}, "
              f"bitwise the wrappers' {torch.equal(got, ref)}")
    del g, want, ref
    torch.cuda.empty_cache()


def sweep_small(b: int, m: int, n: int, ib: int, reps: int, repeat: int) -> None:
    """The small route at each CTA size, and the cluster route at each C
    where it takes the stack too."""
    a = torch.from_numpy(np.random.default_rng(b + m + ib).standard_normal(
        (b, m, n), dtype=np.float32)).cuda()
    want = geqrt.geqrt_batched_plain(a, ib)
    sms = _build.sm_count(a)
    r = max(1, reps // 10) if b > 1000 else reps
    lib = timed(lambda: torch.geqrf(a), r, repeat)
    print(f"geqrt_batched ({b}, {m}, {n}) ib={ib}: the wrappers' plan "
          f"{geqrt.batched_plan(b, m, n, ib, sms)}; torch.geqrf {fmt(lib)}")
    for threads in (128, 256, 512):
        got = geqrt._geqrt_small(a, ib, threads)
        ms = timed(lambda: geqrt._geqrt_small(a, ib, threads), r, repeat)
        per_sm = _build.lib().tq_geqrt_small_per_sm(m, n, ib, threads)
        print(f"geqrt_batched ({b}, {m}, {n}) ib={ib} small, {threads} threads, {per_sm} CTAs an "
              f"SM: {fmt(ms)}, rel {max(rel(g, w) for g, w in zip(got, want)):.3e}")
    for c in CLUSTER_SIZES[1:]:
        if m < n or b * c > sms:
            continue
        plan = geqrt.batched_cluster_plan_at(m, n, ib, c)
        got = geqrt._geqrt_cluster(a, plan)
        ms = timed(lambda: geqrt._geqrt_cluster(a, plan), r, repeat)
        print(f"geqrt_batched ({b}, {m}, {n}) ib={ib} cluster C={c}: {fmt(ms)}, "
              f"rel {max(rel(g, w) for g, w in zip(got, want)):.3e}")
    del a, want
    torch.cuda.empty_cache()


def sweep_tall(b: int, m: int, n: int, ib: int, reps: int, repeat: int) -> None:
    """The tall route at every panel width its kernel is built for,
    beside the one-block kernel and ``torch.geqrf``."""
    a = torch.from_numpy(np.random.default_rng(b + m).standard_normal(
        (b, m, n), dtype=np.float32)).cuda()
    want = geqrt.geqrt_batched_plain(a, ib)
    sms = _build.sm_count(a)
    lib = timed(lambda: torch.geqrf(a), 1, 1)
    one = timed(lambda: geqrt._geqrt_one_block(a, ib), 1, 1)
    print(f"geqrt_batched ({b}, {m}, {n}) ib={ib}: the wrappers' plan "
          f"{geqrt.tall_plan(b, m, n, ib, sms)}; torch.geqrf {fmt(lib)}, the one-block "
          f"kernel {fmt(one)}")
    for w in geqrt.TALL_WIDTHS:
        plan = geqrt.tall_plan_at(b, m, n, ib, sms, w)
        if plan is None:
            continue
        got = geqrt._geqrt_tall(a, plan)
        ms = timed(lambda: geqrt._geqrt_tall(a, plan), reps, repeat)
        resident = _build.lib().tq_geqrt_tall_per_sm(m, w)
        print(f"geqrt_batched[tall] ({b}, {m}, {n}) w={w} ({resident} CTAs an SM fit): "
              f"{fmt(ms)}, rel {max(rel(g, x) for g, x in zip(got, want)):.3e}")
    del a, want
    torch.cuda.empty_cache()


def sweep_project(label: str, m: int, nb: int, n: int, mr: int, modes, fold: bool, reps: int,
                  repeat: int) -> None:
    rng = np.random.default_rng(m + n)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).cuda() / m ** 0.5
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).cuda()
    tm = (torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).cuda() / nb
          if fold else None)
    rb = m // mr
    mm = timed(lambda: y.T @ c, reps, repeat)
    print(f"project {label}: Y ({m}, {nb}), C ({m}, {n}), mr {mr}, op(T) folded: {fold}; "
          f"fp32 torch.matmul Y^T C {fmt(mm)}")
    for mode in modes:
        plan = panel_apply.project_plan(m, n, nb, mr, _build.sm_count(c), mode, fold)
        print(f"project {label} {mode}: the wrappers' plan {plan}")
        for g in range(1, rb + 1):
            if rb % g or g > 64:
                continue
            p = panel_apply.project_plan_at(m, n, nb, mr, g, mode, fold)
            got = panel_apply._launch_project(y, tm, c, mr, mode, p)
            want = panel_apply._project_plain(y, c, mr, mode, g)
            if fold:
                want = tm @ want
            ms = timed(lambda: panel_apply._launch_project(y, tm, c, mr, mode, p), reps, repeat)
            print(f"project {label} {mode} G={g}: {fmt(ms)}, rel {rel(got, want):.3e}")
    del y, c
    torch.cuda.empty_cache()


def sweep_sub(label: str, m: int, n: int, nb: int, modes, reps: int, repeat: int) -> None:
    """Phase 2 (C −= Y·W) on each tile of each mode, beside fp32 addmm."""
    rng = np.random.default_rng(m + n + nb)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).cuda() / nb ** 0.5
    w = torch.from_numpy(rng.standard_normal((nb, n), dtype=np.float32)).cuda()
    c0 = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).cuda()
    lib = timed(lambda: torch.addmm(c0, y, w, alpha=-1.0), reps, repeat)
    print(f"sub {label}: Y ({m}, {nb}), C ({m}, {n}); fp32 torch.addmm {fmt(lib)}")
    c = c0.clone()
    for mode in modes:
        plan = panel_apply.sub_plan(m, n, nb, _build.sm_count(c), mode)
        want = c0 - panel_apply.dot(y, w, mode)
        for tile in panel_apply.tiles_for(mode):
            p = panel_apply.SubPlan(tile)
            got = c0.clone()
            panel_apply._launch_sub(y, w, got, mode, p)
            ms = timed(lambda: panel_apply._launch_sub(y, w, c, mode, p), reps, repeat)
            pick = " (the wrappers' plan)" if tile == plan.tile else ""
            print(f"sub {label} {mode} tile {tile}{pick}: {fmt(ms)}, rel {rel(got, want):.3e}")
        del want
    del y, w, c0, c
    torch.cuda.empty_cache()


def sweep_strip(label: str, nb: int, width: int, rows: int, couples: int, modes, reps: int,
                repeat: int) -> None:
    """K3 (forward, trans, no LARFB) at each stage-1 tile and G, beside the
    plan the wrapper picks; stage 3 on the plan's tile."""
    rng = np.random.default_rng(nb + width + rows)
    v = torch.from_numpy(rng.standard_normal((couples, rows, nb), dtype=np.float32)).cuda()
    v /= rows ** 0.5
    t2 = torch.from_numpy(np.triu(rng.standard_normal((couples, nb, nb), dtype=np.float32)))
    t2 = t2.cuda() / nb
    c0 = torch.from_numpy(rng.standard_normal(((1 + couples) * rows, width + nb),
                                              dtype=np.float32)).cuda()
    args = (v, t2)
    geo = (0, 1, couples, rows, nb, 1, True, False, None, None)
    sms = _build.sm_count(c0)
    for mode in modes:
        plan = chain.strip_plan(nb, width, rows, couples, sms, mode)
        print(f"strip {label} {mode}: nb {nb}, width {width}, {couples} couples of {rows} "
              f"rows; the wrappers' plan {plan}")
        for tile in panel_apply.tiles_for(mode):
            for g in (1, 2, 4, 8):
                if g > 1 and rows // g < chain.GROUP_MIN_ROWS:
                    continue
                p = chain.strip_plan_at(nb, width, rows, couples, tile, g, plan.sub_tile)
                if p.groups != g:
                    continue
                got = c0.clone()
                chain._launch_strip(*args, got, got[:nb, nb:], *geo, mode, p)
                want = c0.clone()
                chain.couple_strip_plain(*args, want, want[:nb, nb:], *geo, mode, groups=g)
                c = c0.clone()
                ms = timed(lambda: chain._launch_strip(*args, c, c[:nb, nb:], *geo, mode, p), reps,
                           repeat)
                pick = " (the wrappers' plan)" if (tile, g) == (plan.proj_tile, plan.groups) else ""
                print(f"strip {label} {mode} tile {tile} G={g}{pick}: {fmt(ms)}, "
                      f"rel {rel(got, want):.3e}")
                del got, want, c
    del v, t2, c0
    torch.cuda.empty_cache()


SWEEPS = ("modlu", "potrf", "ttqrt", "geqrt", "small", "tall", "project", "sub", "strip")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--only", nargs="*", choices=SWEEPS, default=list(SWEEPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plan_sweep: needs a CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    reps, repeat = args.reps, args.repeat
    every = ("highest",) + _build.EMULATED_MODES
    if "modlu" in args.only:
        for nb in (256, 512):
            sweep_modlu(nb, reps, repeat)
    if "potrf" in args.only:
        for b, n in ((1, 256), (1, 512), (4096, 128)):
            sweep_potrf(b, n, reps, repeat)
    if "ttqrt" in args.only:
        sweep_ttqrt(256, 128, reps, repeat)
    if "geqrt" in args.only:
        sweep_geqrt(1, 256, 256, 128, reps, repeat)
        for b, rows in ((32, 2048), (8, 2048), (2, 2048), (1, 1024)):
            sweep_geqrt(b, rows, 512, 128, reps, repeat)
    if "small" in args.only:
        for ib in (32, 128):
            sweep_small(4096, 128, 128, ib, reps, repeat)
        for b, m, n, ib in ((1, 128, 128, 32), (16, 128, 128, 32), (64, 128, 128, 32),
                            (64, 128, 128, 128), (8, 256, 64, 32), (32, 159, 159, 32)):
            sweep_small(b, m, n, ib, reps, repeat)
    if "tall" in args.only:
        for b in (512, 128):
            sweep_tall(b, 2048, 512, 128, max(1, reps // 25), repeat)
        for b in (4096, 140):
            sweep_tall(b, 256, 256, 128, max(1, reps // 5), repeat)
    if "project" in args.only:
        sweep_project("B7a", 4096, 256, 8192, 512, every, False, reps, repeat)
        sweep_project("B6 panel 0", 16384, 256, 16128, 512, every, True, max(1, reps // 10),
                      repeat)
        sweep_project("B6 panel 48", 4096, 256, 3840, 512, every, True, reps, repeat)
        sweep_project("tsqr factor B7", 1048576, 512, 512, 1024, ("b3",), True,
                      max(1, reps // 25), repeat)
    if "sub" in args.only:
        sweep_sub("B7b", 4096, 8192, 256, every, reps, repeat)
        sweep_sub("B6 panel 0", 16384, 16128, 256, ("highest", "b3"), max(1, reps // 10),
                  repeat)
        sweep_sub("B6 panel 60", 1024, 768, 256, ("highest", "b3"), reps, repeat)
        sweep_sub("tsqr factor B7", 1048576, 512, 512, ("b3",), max(1, reps // 25), repeat)
    if "strip" in args.only:
        sweep_strip("hh panel 0", 256, 7936, 1024, 7, every, reps, repeat)
        sweep_strip("hh panel 27", 256, 1024, 1024, 1, ("highest", "b3"), reps, repeat)
        sweep_strip("hh panel 29", 256, 512, 256, 2, ("highest", "b3"), reps, repeat)
        sweep_strip("B14", 256, 8448, 256, 16, ("highest",), reps, repeat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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
kernel is built for (``tall_plan_at``; a CTA a leaf, one an SM), beside
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
The wrappers always take their own plan; this tool builds the plan of
each size itself and calls the C functions directly. Each line: the plan,
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

from tileqr_torch.kernels import _build, geqrt, panel_apply, potrf
from tileqr_torch.kernels.chain import SLAB_COLS, StripPlan, group_rows, strip_workspace
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


def geqrt_at(a: torch.Tensor, ib: int, ctas: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched GEQRT launch on a contiguous CUDA stack (b, m, n), m >=
    n: the one-block kernel at ctas = 1, else the cluster route on C =
    ``ctas`` CTAs a matrix (the block in their shared memory where it
    fits). (packed, T)."""
    b, m, n = a.shape
    if ctas == 1:
        return geqrt._geqrt_one_block(a, ib)
    ibc = min(ib, n)
    resident = cluster_smem_bytes(n, m, ibc, ctas, True) <= SMEM_LIMIT
    return geqrt._geqrt_cluster(a, geqrt.BatchedClusterPlan(
        ctas, ibc, cluster_smem_bytes(n, m, ibc, ctas, resident), resident))


def tall_plan_at(b: int, m: int, n: int, ib: int, sms: int, w: int) -> geqrt.TallPlan:
    """The tall route's plan at panel width ``w``."""
    smem = geqrt.tall_smem_bytes(m, w)
    if m < n or w not in geqrt.TALL_WIDTHS or smem > SMEM_LIMIT:
        raise ValueError(f"tall_plan_at: b={b}, m={m}, n={n}, w={w}")
    return geqrt.TallPlan(w, 1, geqrt.TALL_THREADS, smem, min(b, sms), ib)


def potrf_plan_at(b: int, n: int, ctas: int) -> potrf.PotrfPlan:
    """B9's plan on C = ``ctas`` CTAs a matrix: its blocks in their shared
    memory where they fit, else in the output."""
    if b < 1 or n < 1 or ctas not in CLUSTER_SIZES:
        raise ValueError(f"potrf_plan_at: b={b}, n={n}, ctas={ctas}")
    resident = potrf.potrf_smem_bytes(n, ctas, True) <= SMEM_LIMIT
    return potrf.PotrfPlan(ctas, potrf.potrf_smem_bytes(n, ctas, resident), resident,
                           potrf.potrf_threads(n))


def potrf_at(g: torch.Tensor, plan: potrf.PotrfPlan) -> torch.Tensor:
    """One B9 launch on a contiguous CUDA stack (b, n, n) at ``plan``: R."""
    b, n, _ = g.shape
    r = torch.empty_like(g)
    _build.check(_build.lib().tq_potrf_batched(g.data_ptr(), r.data_ptr(), b, n, 16, plan.ctas,
                                               plan.threads, plan.smem_bytes,
                                               int(plan.resident), _build.stream()),
                 "potrf_batched")
    return r


def project_at(y: torch.Tensor, tm, c: torch.Tensor, mr: int, precision: str,
               groups: int) -> torch.Tensor:
    """One projection launch (``tq_panel_project``) at G = ``groups``: W =
    tm·Σᵢ Yᵢᵀ Cᵢ, or the bare sum when tm is None."""
    m, nb = y.shape
    n = c.shape[1]
    w = torch.empty((nb, n), dtype=c.dtype, device=c.device)
    work = torch.empty(groups * 2 * nb * n, dtype=c.dtype, device=c.device)
    _build.check(_build.lib().tq_panel_project(
        y.data_ptr(), _build.ptr(tm), c.data_ptr(), c.stride(0), m, n, nb, mr, w.data_ptr(),
        work.data_ptr(), groups, panel_apply.passes_of(precision), _build.stream()),
        "panel_project")
    return w


def sub_at(y: torch.Tensor, w: torch.Tensor, c: torch.Tensor, precision: str,
           tile: Tuple[int, int]) -> torch.Tensor:
    """One phase-2 launch (``tq_panel_sub``) on C tiles of ``tile``: C −= Y·W
    in place on any (m, n) view c with unit column stride (Y (m, nb) and W
    (nb, n) contiguous)."""
    m, nb = y.shape
    _build.check(_build.lib().tq_panel_sub(
        y.data_ptr(), w.data_ptr(), c.data_ptr(), c.stride(0), m, c.shape[1], nb, *tile,
        panel_apply.passes_of(precision), _build.stream()), "panel_sub")
    return c


def strip_at(v_stack, t2_stack, c, strip, stack_base: int, base_block: int, n_chunks: int,
             block_rows: int, nb: int, col_start: int, trans: bool, reverse: bool, vkk, tg,
             precision: str, plan: StripPlan):
    """One K3 call (``tq_couple_strip``) at ``plan`` (tiles and G of any
    ``strip_plan``), in place on (c, strip)."""
    work = c.new_empty(plan.workspace)
    _build.check(_build.lib().tq_couple_strip(
        v_stack.data_ptr(), t2_stack.data_ptr(), c.data_ptr(), c.stride(0), strip.data_ptr(),
        strip.stride(0), strip.shape[1], stack_base, base_block, n_chunks, block_rows, nb,
        col_start, int(trans), int(reverse), _build.ptr(vkk), _build.ptr(tg),
        panel_apply.passes_of(precision), work.data_ptr(), *plan.proj_tile, plan.groups,
        *plan.sub_tile, _build.stream()), "couple_strip")
    return c, strip


def strip_plan_at(nb: int, width: int, rows: int, couples: int, precision: str,
                  proj_tile: Tuple[int, int], groups: int, sub_tile: Tuple[int, int],
                  fused: bool) -> StripPlan:
    """K3's plan with the given tiles and G (G cut to its non-empty groups)."""
    gr = group_rows(rows, groups)
    groups = -(-rows // gr)
    return StripPlan(proj_tile, groups, gr, sub_tile, SLAB_COLS,
                     strip_workspace(nb, width, couples, groups, fused))


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
        got = geqrt_at(a, ib, c)
        ms = timed(lambda: geqrt_at(a, ib, c), max(1, reps // 5), repeat)
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
        plan = potrf_plan_at(b, n, c)
        got = potrf_at(g, plan)
        ms = timed(lambda: potrf_at(g, plan), reps, repeat)
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
        got = geqrt_at(a, ib, c)
        ms = timed(lambda: geqrt_at(a, ib, c), r, repeat)
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
    one = timed(lambda: geqrt_at(a, ib, 1), 1, 1)
    print(f"geqrt_batched ({b}, {m}, {n}) ib={ib}: the wrappers' plan "
          f"{geqrt.tall_plan(b, m, n, ib, sms)}; torch.geqrf {fmt(lib)}, the one-block "
          f"kernel {fmt(one)}")
    for w in geqrt.TALL_WIDTHS:
        try:
            plan = tall_plan_at(b, m, n, ib, sms, w)
        except ValueError:
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
            got = project_at(y, tm, c, mr, mode, g)
            want = panel_apply._project_plain(y, c, mr, mode, g)
            if fold:
                want = tm @ want
            ms = timed(lambda: project_at(y, tm, c, mr, mode, g), reps, repeat)
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
            got = sub_at(y, w, c0.clone(), mode, tile)
            ms = timed(lambda: sub_at(y, w, c, mode, tile), reps, repeat)
            pick = " (the wrappers' plan)" if tile == plan.tile else ""
            print(f"sub {label} {mode} tile {tile}{pick}: {fmt(ms)}, rel {rel(got, want):.3e}")
        del want
    del y, w, c0, c
    torch.cuda.empty_cache()


def sweep_strip(label: str, nb: int, width: int, rows: int, couples: int, modes, reps: int,
                repeat: int) -> None:
    """K3 (forward, trans, no LARFB) at each stage-1 tile and G, beside the
    plan the wrapper picks; stage 3 on the plan's tile."""
    from tileqr_torch.kernels import chain

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
                p = strip_plan_at(nb, width, rows, couples, mode, tile, g, plan.sub_tile, False)
                if p.groups != g:
                    continue
                c = c0.clone()
                got = strip_at(*args, c, c[:nb, nb:], *geo, mode, p)
                want = c0.clone()
                chain.couple_strip_plain(*args, want, want[:nb, nb:], *geo, mode, groups=g)
                c = c0.clone()
                ms = timed(lambda: strip_at(*args, c, c[:nb, nb:], *geo, mode, p), reps, repeat)
                pick = " (the wrappers' plan)" if (tile, g) == (plan.proj_tile, plan.groups) else ""
                print(f"strip {label} {mode} tile {tile} G={g}{pick}: {fmt(ms)}, "
                      f"rel {rel(got[0], want):.3e}")
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

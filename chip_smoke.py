#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's square, tall-skinny and batched paths on
one GPU and check them.

    python3 chip_smoke.py            # from the repository root

Builds the CUDA kernels from ``tileqr_torch/csrc`` into ``build/`` on first
use (one nvcc per source, in parallel), then:

1. holds each hh kernel K1-K4 against its plain torch version on the card,
   in fp32, at the hh path's shapes (nb=256, ib=128, head couples of nb
   rows, chunk couples of 4·nb rows, a strip of 7936 columns), and times
   kernel, plain version and the PyTorch call that computes the same
   function (``torch.geqrf`` / ``torch.ormqr``); prints the thread-block
   cluster K1 and K2 run on (``cluster_plan``: CTAs, rows and shared bytes
   per CTA, whether the active block is resident) and the plans K3 and K4
   run on (``strip_plan``: stage 1's tile and row groups G, stage 3's
   tile, stage 2's row bands), and holds and times K3 at a late panel's
   width too (one couple of 4·nb rows on 1024 columns, LARFB fused: the
   small tiles and G = 2, against the plain version summed in the same
   groups, rerun bitwise) and panel 0's sweep as the narrow update runs it
   (heads with the LARFB, then chunks, on 256 columns: the chain on 4 row
   bands a block);
2. runs ``tileqr_torch.qr`` at 8192² with the default QRConfig (hh) and
   checks, in float64 on the card: the project's relerr ‖QᵀA−R‖F/‖A‖F (Qᵀ
   applied through the reflectors) ≤ 1e-6; the residual with the explicitly
   formed Q, ‖A−QR‖F/‖A‖F ≤ 3e-6 (fp32 rounding of forming Q puts even
   cuSOLVER near 1.2e-6, so it is printed beside ours); ‖QᵀQ−I‖F ≤ 1e-3;
   that K1-K4 launched, no hr kernel did and no plain version ran; that
   ``qr_factor`` reruns are bitwise equal; and ``lstsq`` on 16 right-hand
   sides;
3. times the hh ``qr_factor``, ``qr`` and ``torch.linalg.qr(mode="r")``;
4. holds the hr kernels against their plain versions on a 16384² gaussian
   A: B8 (modified LU) on panel 0's Q_top and B9 (POTRF) on its gram, as
   ``hr_panel`` hands them over, and B6 (whole-panel apply) on panels 0 and
   48; times each with its plain version and the PyTorch call that
   computes the same function, checked once against the plain version:
   ``torch.linalg.lu_factor(Q_top − diag(d), pivot=False)`` for B8 (d from
   the modified LU), ``torch.linalg.cholesky`` for B9, and for B6
   ``torch.ormqr`` with tau = diag(T) (T is larft's for the compact-WY Y,
   so it applies the same Qᵀ); B6's three-matmul chain is timed beside it,
   and its two phases apart, each with its plan (``project_plan``'s G,
   ``sub_plan``'s tile);
   B8's and B9's reruns must be bitwise equal (B9's R zero below its
   diagonal), and their clusters are printed beside their times
   (``modlu_plan``: CTAs, panel width, shared bytes per CTA, whether the
   block is resident in shared memory; ``potrf_plan``: CTAs a matrix,
   shared bytes, whether the 16-row blocks are resident);
5. runs ``tileqr_torch.qr`` with ``square_method="hr"`` at 16384² (64
   panels) and checks the same metrics, that the health is ≤ hr_guard_tau
   with no guard warning, that B6, B8, B9 and B7 (``orgqr``'s windows
   wider than 1024 columns) launched and nothing else did, no plain
   version ran, reruns bitwise equal, and ``lstsq``. On this path
   the explicit-Q residual is gated at 1e-6 (BASELINE's gate). Its relerr
   ‖QᵀA−R‖F/‖A‖F is printed twice, each gated at 1e-6: with Qᵀ applied
   through the factors' reflectors in float64 on the card (the
   factorization's own error) and with the fp32 ``apply_q`` a user calls,
   which adds that apply's rounding (B7 with its Kahan sums, for targets
   wider than 1024 columns);
6. times the hr ``qr_factor``, ``qr`` and ``torch.linalg.qr(mode="r")`` at
   16384²;
7. the tall-skinny path at BASELINE config 3, a 1048576×512 gaussian A with
   ``QRConfig(nb=512)``: holds the batched GEQRT against its plain version
   on the 512 leaves of 2048 rows (the tall route, ``tall_plan`` printed)
   and on each tree level's stack as ``tsqr_factor`` forms it (128 stacks
   of 2048×512 on the tall route; 32, 8, 2 stacks of 2048×512 and 1 of
   1024×512 on the cluster route, ``batched_cluster_plan``'s C printed),
   each rerun bitwise, and times each beside its plain version,
   ``torch.geqrf`` and the one-block kernel on the same stack; runs
   ``tsqr(a, "r")`` (auto → tree) with the counts set to 0 just before and
   read just after (each route launched as often as the plans say: the
   leaves and the first level on the tall route, four levels on the
   cluster route; no other kernel, no plain version) and
   ``tsqr(a, "reduced")``, and checks the relerr ‖QᵀA − [R; 0]‖F/‖A‖F
   through ``apply_q`` on the tree's ``TSQRFactors`` ≤ 1e-6, the explicit-Q
   residual ≤ 3e-6, ‖QᵀQ − I‖F ≤ 1e-3, R against ``torch.linalg.qr`` up to
   row signs (printed), bitwise reruns; then ``tsqr(a, "factor")`` (auto →
   cholqr2 → ``HRFactors``): health ≤ hr_guard_tau with no guard warning,
   B9 and B8 launched at n = 512, the relerr with Qᵀ applied in float64
   ≤ 1e-6, and the fp32 ``apply_q`` relerr printed (held to 3e-6 when above
   1e-6, as for hr); B9 on that panel's gram (1, 512, 512) and B8 at
   nb = 512 on its Q_top against their plain versions (d bitwise equal),
   rerun bitwise, and timed beside their plain versions, bounds,
   ``torch.linalg.cholesky`` and ``lu_factor``, with their clusters; ``apply_q`` in "b3" of those factors to A, with the
   counts set to 0 just before and read just after (nb = 512: one launch
   of B7's split instantiation, no plain version; relerr ≤ 1e-4), and B7
   at that shape against its b3 and "highest" plain versions summed in the
   card's row-block groups (``project_plan``: G = 4 there), its phase 1
   alone likewise, timed, with each phase's time; times
   ``tsqr`` r (tree), factor (cholqr2), factor + ``apply_q`` on 16 columns
   and ``torch.linalg.qr(mode="r")``;
8. the batched path at BASELINE config 4, a (4096, 128, 128) gaussian
   stack with the default QRConfig: holds the small route (B11 at ib = 32,
   ``qr_batched``'s width, and B16 at ib = 128; the route, its threads,
   shared bytes and CTAs an SM printed) against its plain version, rerun
   bitwise, each ib block's T against ``t_from_gram`` of the kernel's own
   reflectors, and ``geqrt`` on one 256² tile (B1s: the cluster route;
   rerun bitwise), each timed beside ``torch.geqrf`` (B1s also beside the
   one-block kernel); the one-block kernel at a stack it keeps (64 wide
   256×512 matrices, which no path runs: 0 launches in the line) against
   its plain version, rerun bitwise, timed beside ``torch.geqrf``; the
   tall route on ``qr_batched``'s 4096 × 256² (past the small route)
   likewise, beside the one-block kernel on the same stack; runs
   ``qr_batched(a)`` with the counts set to 0 just
   before and read just after (one small-route launch, no plain version) and
   checks the max over the batch of ‖A − QR‖F/‖A‖F ≤ 1e-6 and of
   ‖QᵀQ − I‖F ≤ 1e-3 and bitwise reruns; with
   ``batched_method="cholqr2"`` the guard must trip on the gaussian stack
   (its ill-conditioned tail) and the fallback meet the same gates, and on
   a well-conditioned stack (G + 4·√128·I) must not trip: health ≤ tau,
   one B9 launch, no GEQRT launch, the same gates; B9 on that stack's gram
   (4096, 128, 128: a CTA a matrix) against its plain version, rerun
   bitwise, timed beside ``torch.linalg.cholesky``; times both methods
   beside ``torch.linalg.qr`` on the stack;
9. the emulated precisions "b3", "b4" and "default" (bf16 split products
   on the tensor cores, ``csrc/tile_gemm.cuh``): K3 and K4 at phase 1's
   shapes (and at the late panel's width, with their plans, and the fp32
   ``torch.ormqr`` timed beside each), B6 on panels 0 and 48 of a 16384² A
   (its two phases timed apart) and B7 (also in "highest")
   on ``orgqr``'s k = 0 (16384², both trans) and k = 63 (256²) windows,
   each held against the plain version of its own mode (its phase 1 summed
   in the card's row-block groups, ``project_plan``) within
   ``TOL_MODE_KERNEL`` and printed beside its distance to the "highest"
   plain version, which must be larger (the split ran); each timed beside
   that plain version and three bf16 ``torch.matmul`` calls of the same
   shapes (one pass; no single PyTorch call computes the split product, so
   the library column is empty; B7 in "highest" is timed beside
   ``torch.ormqr`` with tau = diag(T), checked once against it); then ``qr`` at 8192² on the hh path and
   at 16384² on the hr path in each mode, with the counts set to 0 just
   before and read just after (only that mode's K3/K4 or B6/B7 and the fp32
   panel kernels launch, no plain version runs), checked: relerr
   ‖QᵀA − R‖F/‖A‖F (Qᵀ in float64 for hr, the fp32 "highest" apply for hh)
   and the explicit-Q residual ≤ 1e-4 in b3/b4 (1e-1 in "default"), orth
   ≤ 1e-2 in b3/b4, hr health ≤ tau, bitwise reruns; and ``qr_factor``
   timed in each mode beside "highest" and cuSOLVER;
10. the sharded path at BASELINE config 5's mesh and tile (4×2, nb = 256),
   cut to a 16384² gaussian A: first, on this process, the TTQRT kernel
   (B15: the cluster routine on the couple's live rows) on two R tiles of
   that A against its plain version and against the TSQRT kernel (K2's
   cluster routine on all the couple's rows, whose sums go in another
   order: rel ≤ 1e-5, printed), rerun bitwise, with its cluster
   (``ttqrt_plan``) and its time beside the TSQRT kernel's on the same
   couple; the single-tile entries
   tsqrt, larfb and ssrfb (K2, K4, K3; ssrfb at the strip tree's width),
   the panel head (B13: K1 on a rank's panel column) and ``couple_apply``
   (B14: K3 with nb-row couples, at tileqr's static driver's shape for this
   mesh), each against its plain version and timed beside it and the
   PyTorch call that computes the same function (``torch.geqrf`` or
   ``torch.ormqr`` with tau = diag(T)); tsqrt, larfb and ``couple_apply``,
   which no path runs, are recorded as shapes of K2, K4 and K3, whose rows
   name their TPU kernels too; then 8 spawned ranks on the one
   card (``tileqr_torch.dist.launch``, gloo: NCCL refuses two ranks on one
   device) run ``qr_sharded(mode="factor")``, ``assemble_r_sharded`` and
   ``apply_q_sharded(f, A)`` with the counts set to 0 just before and read
   just after on every rank: each rank's factor launches equal the
   geometry's plan, no plain version runs; relerr ‖QᵀA − R‖F/‖A‖F
   ≤ 1e-6 (float64 norms), Q = ``apply_q_sharded(f, I, trans=False)``:
   explicit-Q residual ≤ ``TOL_SH_RESID`` = 4e-6 (the reason is beside it)
   and ‖QᵀQ − I‖F ≤ 1e-3; R against the single-card hh ``qr``'s R with
   row signs matched (printed), the factor's rerun bitwise on
   every rank, its wall time by CUDA events on rank 0 between barriers (8
   ranks time-sharing one card, not a multi-GPU figure), and the bytes per
   panel through each collective with the host-staged share;
11. the hr sharded path (square_method="hr": CholeskyQR2 panels over the
   mesh rows, ``drivers/sharded_hr.py``) at the same mesh, tile and cut
   size: first, on this process, B7's halves ``panel_project`` (B7a) and
   ``panel_sub`` (B7b) at rank (0, 0)'s segment-0 local shape (Y 4096×256,
   C 4096×8192, Kahan row blocks of 512) in "highest", "b3", "b4" and
   "default", each against its plain version of the same mode, timed
   beside it and beside the fp32 ``torch.matmul`` (TF32 off) that computes
   the same function (Yᵀ·C; C − Y·W by ``torch.addmm``), labelled "fp32";
   then, in the same world of 8 ranks as phase 10 (one spawn), in
   "highest" and in "b3": ``qr_sharded(mode="factor")``,
   ``assemble_r_sharded``, ``apply_q_sharded(f, A)`` and Q =
   ``apply_q_sharded(f, I, trans=False)``, the counts set to 0 just before
   each and read just after: every rank's factor launches equal
   ``drivers/sharded_hr.planned_launches_hr`` (B9 and B8 on every panel,
   and in b3 the halves; "highest" takes tileqr's plain torch routes),
   each apply's the halves' plan, R launches nothing, no plain version
   runs; health ≤ hr_guard_tau with no guard warning;
   relerr ‖QᵀA − R‖F/‖A‖F ≤ 1e-6, explicit-Q residual ≤ 3e-6 and
   ‖QᵀQ − I‖F ≤ 1e-3 in "highest" (1e-4, 1e-4, 1e-2 in b3); the factor's
   rerun bitwise equal on every rank and r_diag, t_all and health bitwise
   equal across the ranks; printed: R against the single-card hr R of the
   same mode with row signs matched, the factor's wall time by CUDA events
   on rank 0 between barriers, and the bytes per panel through each
   collective with the host-staged share.

Every kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over their
type's peak, computed from this run's shapes, a triangular factor counting
its triangle only: fp32 at 67 TFLOP/s, and the
split products' bf16 passes (3, 4 or 1 per product) at the dense bf16
tensor-core rate of 989 TFLOP/s. Every kernel of the ``kernels`` line
must have launched in its path's counted run. Any failure raises
(non-zero exit). With no CUDA device it exits non-zero and prints no
result. The last line is the device record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from tileqr_torch.kernels._build import (EMULATED_MODES, MODE_KERNELS, SHARDED_HR_KERNELS,
                                         TS_KERNELS)
from tileqr_torch.kernels.common import counter_key, passes_of

NB, IB, CHUNK = 256, 128, 4
N = 8192  # hh path
N_HR = 16384  # hr path: the BASELINE gate size, 64 panels
HR_PANELS_TIMED = (0, 48)
TOL_KERNEL = 1e-5
TOL_RELERR, TOL_RESID, TOL_ORTH, TOL_LSTSQ = 1e-6, 3e-6, 1e-3, 1e-5
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor cores

# a kernel against its own mode's plain version: "default" keeps no lo
# half, so where the two fp32 sums of an intermediate (W, W2) differ in the
# last bit its bf16 rounding can flip (2^-9 relative in that entry), and
# the flips compound over a strip's chained couples: 1.1e-4..3.8e-4 on K3
# and K4, against that mode's own 2.3e-3..8.6e-3 from "highest" (PERF.md)
TOL_MODE_KERNEL = {"highest": TOL_KERNEL, "b3": TOL_KERNEL, "b4": TOL_KERNEL, "default": 1e-3}
# qr in a mode: relerr and explicit-Q residual (and orth, b3/b4 only)
TOL_MODE_RELERR = {"b3": 1e-4, "b4": 1e-4, "default": 1e-1}
TOL_MODE_ORTH = 1e-2

M_TS, N_TS, NB_TS = 1048576, 512, 512  # BASELINE config 3 (tall-skinny)
B_BA, N_BA = 4096, 128  # BASELINE config 4 (batched)
# BASELINE config 5's mesh and tile, cut from 32768² to 16384²: its
# replicated outputs would be 4 GiB per rank, ~110 GiB over 8 ranks on one card
N_SH, MESH_SH = 16384, (4, 2)
# its explicit-Q residual: the hh limit of 3e-6 was set at 8192², where
# cuSOLVER measures 1.21e-6; at 16384² cuSOLVER measures 1.73e-6 (1.43x,
# which puts the same margin at 4.3e-6), and the mesh rows add the tree's
# leaf strips, which take every local couple's update of their panels: in
# fp32 on the CPU tileqr's own sharded driver grows as the port does, 1x1
# → 2x1 → 4x2 (tests/test_torch_sharded_growth.py; on the card
# utils/sharded_errors.py; PERF.md §6)
TOL_SH_RESID = 4e-6
# the hr sharded path (phase 11): its modes and their (relerr, explicit-Q
# residual, orth) limits
SH_HR_MODES = ("highest", "b3")
TOL_SH_HR = {"highest": (TOL_RELERR, TOL_RESID, TOL_ORTH),
             "b3": (TOL_MODE_RELERR["b3"], TOL_MODE_RELERR["b3"], TOL_MODE_ORTH)}

# B15's single-tile tsqrt and larfb and B14's couple_apply are K2, K4 and K3
# at one shape that no path runs (tileqr's unit-test entries; B14 is the
# static driver's sweep, which the port's driver runs as K3 at chunk 1):
# they stand in those kernels' rows, checked and timed as labelled shapes
KERNEL_INFO = {
    "panel_factor": ("tileqr_torch/csrc/panel.cu", "tileqr/kernels/panel.py:90"),
    "panel_chain": ("tileqr_torch/csrc/chain.cu",
                    "tileqr/kernels/chain.py:83, tileqr/kernels/tsqrt.py:46"),
    # K3's three stages: strip.cu's projections and chain, panel_apply.cu's
    # phase 2 over the stacked couples, all on tile_gemm.cuh's routines
    "couple_strip": ("tileqr_torch/csrc/strip.cu + tileqr_torch/csrc/panel_apply.cu + "
                     "tileqr_torch/csrc/tile_gemm.cuh",
                     "tileqr/kernels/chain.py:212, tileqr/kernels/update.py:115"),
    "larfb_strip": ("tileqr_torch/csrc/strip.cu + tileqr_torch/csrc/tile_gemm.cuh",
                    "tileqr/kernels/chain.py:267, tileqr/kernels/larfb.py:44"),
    "modified_lu": ("tileqr_torch/csrc/modlu.cu", "tileqr/kernels/modlu.py:93"),
    "potrf_batched": ("tileqr_torch/csrc/potrf.cu", "tileqr/drivers/cholqr.py:203"),
    "panel_apply_carry": ("tileqr_torch/csrc/panel_apply.cu + tileqr_torch/csrc/tile_gemm.cuh",
                          "tileqr/kernels/panel_apply.py:227"),
    # the batched GEQRT's one-block kernel, its tile in global memory: the
    # stacks no other route takes (m < n past the small route; tall n = 8
    # leaves of 131072 rows in stacks past the cluster route), which no
    # path runs: held and timed at a wide stack, 0 launches on the paths
    "geqrt_batched": ("tileqr_torch/csrc/geqrt_batched.cu + tileqr_torch/csrc/geqrt.cuh",
                      "tileqr/drivers/batched.py:41, tileqr/drivers/tsqr.py:217"),
    # its tall route: panels in shared memory, a persistent CTA a matrix (the
    # tsqr leaves and the tree's level of 128 stacks)
    "geqrt_batched[tall]": ("tileqr_torch/csrc/geqrt_tall.cu + tileqr_torch/csrc/tile_gemm.cuh",
                            "tileqr/drivers/tsqr.py:217"),
    # the batched GEQRT's cluster route: small stacks (the tsqr tree's
    # levels of 32, 8, 2, 1 matrices; B1s), one thread-block cluster a matrix
    "geqrt_batched[cluster]": ("tileqr_torch/csrc/geqrt_batched.cu + "
                               "tileqr_torch/csrc/geqrt_cluster.cuh",
                               "tileqr/drivers/tsqr.py:217, tileqr/kernels/geqrt.py:225"),
    # its small route: a matrix a CTA, several an SM (qr_batched's stacks:
    # B11 at ib 32 on the path, B16 at ib 128)
    "geqrt_batched[small]": ("tileqr_torch/csrc/geqrt_small.cu",
                             "tileqr/drivers/batched.py:167, tileqr/drivers/batched.py:41"),
    "panel_apply": ("tileqr_torch/csrc/panel_apply.cu + tileqr_torch/csrc/tile_gemm.cuh",
                    "tileqr/kernels/panel_apply.py:112"),
    "ttqrt": ("tileqr_torch/csrc/ttqrt.cu", "tileqr/kernels/ttqrt.py:68"),
    # TPU kernels that the sharded path runs as K1/K3 with counters of their own
    "panel_head": ("tileqr_torch/csrc/panel.cu", "tileqr/drivers/sharded_dyn.py:172"),
    "ssrfb": ("tileqr_torch/csrc/strip.cu + tileqr_torch/csrc/panel_apply.cu + "
              "tileqr_torch/csrc/tile_gemm.cuh", "tileqr/kernels/ssrfb.py:44"),
}
# the split-product instantiations (the in-kernel _dot_bx of tileqr/kernels/common.py:95)
KERNEL_INFO.update({
    f"{k}[{m}]": (f"{KERNEL_INFO[k][0]} + tileqr_torch/csrc/bx_mma.cuh", KERNEL_INFO[k][1])
    for k in MODE_KERNELS if k not in SHARDED_HR_KERNELS for m in EMULATED_MODES
})
# B7's halves, which the hr sharded path launches with its sum over the mesh
# rows between them in its emulated modes (b3 here; "highest" takes tileqr's
# plain routes, so the fp32 instantiation is checked and timed but not listed)
KERNEL_INFO.update({
    f"{k}[{m}]": ("tileqr_torch/csrc/panel_apply.cu + tileqr_torch/csrc/tile_gemm.cuh + "
                  "tileqr_torch/csrc/bx_mma.cuh", f"tileqr/kernels/panel_apply.py:{line}")
    for k, line in zip(SHARDED_HR_KERNELS, (307, 349)) for m in SH_HR_MODES if m != "highest"
})


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps calls (warm)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(x: torch.Tensor, y: torch.Tensor) -> float:
    d = torch.linalg.norm((x - y).double())
    return float(d / max(float(torch.linalg.norm(y.double())), 1e-30))


def max_abs(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x - y).abs().max()) if x.numel() else 0.0


def geqrf_flops(m: int, n: int) -> float:
    """LAPACK's count for a Householder QR of an (m, n) block."""
    if m < n:
        return 2.0 * n * m * m - 2.0 * m ** 3 / 3.0
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0


class KernelRecord:
    def __init__(self):
        self.err = {k: 0.0 for k in KERNEL_INFO}
        self.ms, self.plain_ms, self.library_ms, self.bound = {}, {}, {}, {}

    def compare(self, name: str, label: str, got, want, tol: float = TOL_KERNEL) -> None:
        for i, (g, w) in enumerate(zip(got, want)):
            r = rel(g, w)
            self.err[name] = max(self.err.get(name, 0.0), max_abs(g, w))
            print(f"kernel {name} {label} out{i}: rel_fro={r:.3e}")
            require(np.isfinite(r) and r <= tol,
                    f"{name} {label} output {i} differs from its plain version: {r:.3e}")

    @staticmethod
    def bound_of(flops: float, nbytes: float, bf16_flops: float = 0.0):
        """fp32 flops at the CUDA-core peak plus bf16 flops at the
        tensor-core peak, against the bytes at the HBM rate."""
        t_ops = (flops / PEAK_FLOPS + bf16_flops / PEAK_BF16) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    def set_bound(self, name: str, flops: float, nbytes: float, bf16_flops: float = 0.0) -> None:
        self.bound[name] = self.bound_of(flops, nbytes, bf16_flops)

    def time(self, name: str, kern, plain, library, reps: int, preps: int, card: str,
             label: str = "", bound=None) -> None:
        """Times of the kernel, its plain version and the library call. With
        a label (another shape of the same kernel) they are printed only,
        beside that shape's ``bound`` (from ``bound_of``)."""
        for fn in (kern, plain, library):
            if fn is not None:
                fn()
        torch.cuda.synchronize()
        ms, pms = cuda_ms(kern, reps), cuda_ms(plain, preps)
        lms = cuda_ms(library, reps) if library is not None else None
        if not label:
            self.ms[name], self.plain_ms[name], self.library_ms[name] = ms, pms, lms
        lib = "none" if library is None else f"{lms:.4f} ms"
        b, by = bound if label else self.bound[name]
        print(f"time {name}{' ' + label if label else ''}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"library {lib}, bound {b:.4f} ms ({by}) [{card}]")

    def line(self, launches: dict) -> list:
        return [
            {"name": k, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[k], "max_abs_err": self.err[k],
             "ms": self.ms[k], "plain_ms": self.plain_ms[k], "bound_ms": self.bound[k][0],
             "bound_by": self.bound[k][1], "library_ms": self.library_ms[k]}
            for k, (src, rep) in KERNEL_INFO.items()
        ]


def phase1(a: torch.Tensor, rec: KernelRecord, card: str) -> None:
    """Each hh kernel against its plain version at the hh path's shapes. The
    hh path runs a panel's K1 and K2 as one launch (``chain.panel_column``,
    counted as ``panel_factor``), so the ``panel_factor`` row is that
    launch's: its comparison, time and bound; K1 alone (B13's launch) is
    compared and timed beside it."""
    from tileqr_torch.kernels import chain, panel

    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK

    # K1: GEQRT of tile (0, 0) + the 3 head couples of panel 0
    got = panel.panel_factor(a, 0, NB, IB, n_head)
    want = panel.panel_factor_plain(a, 0, NB, IB, n_head)
    rec.compare("panel_factor", "K1 alone k=0 n_head=3", got, want)
    r_k, v_stack, tg, t2h = want

    # K2: the 7 chunk couples of 4·nb rows below the head
    got = chain.panel_chain(a, r_k, 0, NB, 1, n_chunks, br, IB)
    want = chain.panel_chain_plain(a, r_k, 0, NB, 1, n_chunks, br, IB)
    rec.compare("panel_chain", f"n_chunks={n_chunks} rows={br}", got, want)
    _, v_chunks, t2t = want

    # the hh path's launch: K1 and K2 of panel 0 in one, against the plain
    # K1 then K2
    column = lambda: chain.panel_column(a, 0, NB, IB, n_head, 1, n_chunks, br)  # noqa: E731
    rec.compare("panel_factor", f"K1 + K2 in one launch n_head={n_head} n_chunks={n_chunks}",
                column(), (want[0], v_stack, tg, t2h, v_chunks, t2t))

    # bounds at these shapes (fp32, 4 bytes an element)
    head_rows = (1 + n_head) * NB
    head_bound = rec.bound_of(geqrf_flops(head_rows, NB),
                              4 * (head_rows * NB + NB * NB * (2 + 2 * (1 + n_head))))
    chain_rows = NB + n_chunks * br
    rec.set_bound("panel_chain", geqrf_flops(chain_rows, NB),
                  4 * (2 * n_chunks * br * NB + 2 * NB * NB + n_chunks * NB * NB))
    column_rows = head_rows + n_chunks * br
    rec.set_bound("panel_factor", geqrf_flops(column_rows, NB),
                  4 * (2 * column_rows * NB + NB * NB * (2 + (1 + n_head) + n_chunks)))

    # the PyTorch calls that compute the same functions (yardsticks, never
    # called by the port): geqrf of the panel blocks, ormqr of their
    # reflectors on the same strip
    head_blk = a[:head_rows, :NB].contiguous()
    chain_blk = torch.cat([r_k, a[br : br * (1 + n_chunks), :NB]]).contiguous()
    column_blk = a[:column_rows, :NB].contiguous()
    strip_kernels(a, rec, card, (v_stack, tg, t2h, v_chunks, t2t), "highest",
                  strip_libraries(a, r_k))

    # times at the same shapes
    rec.time("panel_factor", column,
             lambda: (panel.panel_factor_plain(a, 0, NB, IB, n_head),
                      chain.panel_chain_plain(a, r_k, 0, NB, 1, n_chunks, br, IB)),
             lambda: torch.geqrf(column_blk), 5, 1, card)
    rec.time("panel_factor", lambda: panel.panel_factor(a, 0, NB, IB, n_head),
             lambda: panel.panel_factor_plain(a, 0, NB, IB, n_head),
             lambda: torch.geqrf(head_blk), 5, 1, card, label="K1 alone", bound=head_bound)
    rec.time("panel_chain", lambda: chain.panel_chain(a, r_k, 0, NB, 1, n_chunks, br, IB),
             lambda: chain.panel_chain_plain(a, r_k, 0, NB, 1, n_chunks, br, IB),
             lambda: torch.geqrf(chain_blk), 5, 1, card)
    print_cluster("panel_factor", 2 * NB, IB)
    print_cluster("panel_chain", NB + br, IB)
    print_pipeline("panel_factor (K1 alone)", 1 + n_head, 2 * NB)
    print_pipeline("panel_chain", n_chunks, NB + br, full_first=True)
    print_pipeline("panel_column (K1 + K2, the hh driver's launch)", 1 + n_head + n_chunks,
                   NB + br)


def strip_libraries(a: torch.Tensor, r_k: torch.Tensor):
    """The PyTorch calls that compute K3's and K4's functions at the hh
    path's panel-0 shapes (yardsticks, never called by the port): ormqr of
    the chunk couples' and of the diagonal tile's geqrf on the same strip."""
    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK
    chain_qr = torch.geqrf(torch.cat([r_k, a[br : br * (1 + n_chunks), :NB]]).contiguous())
    tile_qr = torch.geqrf(a[:NB, :NB].contiguous())
    c_all = torch.cat([a[:NB, NB:], a[br : br * (1 + n_chunks), NB:]]).contiguous()
    strip_c = a[:NB, NB:].contiguous()
    return (lambda: torch.ormqr(chain_qr[0], chain_qr[1], c_all, left=True, transpose=True),
            lambda: torch.ormqr(tile_qr[0], tile_qr[1], strip_c, left=True, transpose=True))


def print_cluster(name: str, rows: int, ib: int) -> None:
    """The thread-block cluster a K1/K2 launch of couples of ``rows`` rows
    runs on (``kernels/geqrt.py:cluster_plan``)."""
    from tileqr_torch.kernels.geqrt import cluster_plan

    plan = cluster_plan(NB, rows, ib)
    print(f"cluster {name}: couple rows {rows}, C={plan.ctas} CTAs, "
          f"{plan.rows_per_cta} rows and {plan.smem_bytes} shared bytes per CTA, "
          f"active block resident in shared memory: {plan.resident}")


def print_pipeline(name: str, steps: int, rows: int, full_first: bool = False) -> None:
    """Whether a K1/K2 launch of ``steps`` couples runs pipelined by ib
    block (``kernels/panel.py:pipeline_plan``), its q stages and each
    stage's cluster."""
    from tileqr_torch.kernels import panel

    plan = panel.pipeline_plan(NB, IB, steps, rows, full_first)
    engaged = panel._pipelined(NB, IB, steps, rows, full_first) is not None
    c = plan.cluster
    print(f"pipeline {name}: {steps} steps, q={plan.stages} stages (R rows {plan.windows}), "
          f"each a cluster of C={c.ctas} CTAs over at most {plan.rows} rows "
          f"({c.rows_per_cta} a CTA, {c.smem_bytes} shared bytes, resident {c.resident}); "
          f"pipelined: {engaged}")
    require(engaged, f"{name} did not take the pipeline")


def compare_mode(rec: KernelRecord, name: str, mode: str, label: str, got, want,
                 want_highest) -> None:
    """A kernel against its own mode's plain version; in an emulated mode
    also its distance to the "highest" plain version, which must be the
    larger (the split product ran)."""
    rec.compare(counter_key(name, mode), label, [got], [want], TOL_MODE_KERNEL[mode])
    if mode != "highest":
        d_own, d_hi = rel(got, want), rel(got, want_highest)
        print(f"kernel {counter_key(name, mode)} {label}: to its own mode's plain version "
              f"{d_own:.3e}, to the 'highest' plain version {d_hi:.3e}")
        require(d_own < d_hi, f"{name}[{mode}] {label} is not nearer its own mode")


def bf16_chain_ms(fn, card: str, what: str) -> None:
    """Time three bf16 torch.matmul calls of a kernel's shapes (one pass)."""
    fn()
    torch.cuda.synchronize()
    print(f"time {what}: three bf16 torch.matmul calls (one pass, same shapes) "
          f"{cuda_ms(fn, 5):.4f} ms [{card}]")


def strip_kernels(a: torch.Tensor, rec: KernelRecord, card: str, fac, mode: str,
                  libraries) -> None:
    """K3 and K4 in one precision mode at the hh path's shapes, against the
    plain version of the same mode: bounds and times beside that plain
    version and the library calls (``libraries``: the library column in
    "highest", the fp32 call timed beside them in an emulated mode, with
    three bf16 matmuls of the same shapes); the plans; K3 at a late
    panel's width (``late_strip``)."""
    from tileqr_torch.kernels import chain
    from tileqr_torch.kernels.common import unit_lower

    v_stack, tg, t2h, v_chunks, t2t = fac
    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK
    width = a.shape[1] - NB
    k3, k4 = counter_key("couple_strip", mode), counter_key("larfb_strip", mode)
    pm = dict(precision=mode)

    # K3: the variants of the factor sweep (trans, forward) and the Q sweep
    # (no trans, reverse), fused LARFB on and off, col_start 1 and 0
    variants = [
        ("head trans fwd fused cs=1", (v_stack, t2h, 1, 1, n_head, NB), 1, True, False, True),
        ("chunks trans fwd cs=1", (v_chunks, t2t, 0, 1, n_chunks, br), 1, True, False, False),
        ("chunks notrans rev fused cs=0", (v_chunks, t2t, 0, 1, n_chunks, br), 0, False, True, True),
        ("head notrans rev cs=0", (v_stack, t2h, 1, 1, n_head, NB), 0, False, True, False),
    ]
    for label, (vs, ts, sb, bb, nc, rows), cs, trans, rev, fused in variants:
        outs = []
        runs = [(chain.couple_strip, mode), (chain.couple_strip_plain, mode)]
        if mode != "highest":
            runs.append((chain.couple_strip_plain, "highest"))
        for fn, prec in runs:
            c = a.clone()
            strip = c[:NB, cs * NB :]
            fn(vs, ts, c, strip, sb, bb, nc, rows, NB, cs, trans=trans, reverse=rev,
               vkk=v_stack[0] if fused else None, tg=tg if fused else None, precision=prec)
            rows_touched = torch.cat([c[:NB], c[bb * rows : (bb + nc) * rows]])
            outs.append(rows_touched[:, cs * NB :])
        compare_mode(rec, "couple_strip", mode, label, outs[0], outs[1], outs[-1])
        del outs

    # K4: both trans values on the 7936-column strip
    for trans in (True, False):
        outs = []
        for fn, prec in [(chain.larfb_strip, mode), (chain.larfb_strip_plain, mode),
                         (chain.larfb_strip_plain, "highest")]:
            s1 = a[:NB, NB:].clone()
            fn(v_stack[0], tg, s1, NB, trans=trans, precision=prec)
            outs.append(s1)
        compare_mode(rec, "larfb_strip", mode, f"trans={trans}", outs[0], outs[1], outs[2])

    # bounds: the products' flops (bf16 passes in an emulated mode), the
    # adds in fp32, each input read once and each output written once; a
    # triangular factor (T, T2, K4's unit-lower V) counts its triangle only,
    # so a product with it costs NB²·width where a dense one costs 2·NB²·width
    p = passes_of(mode)
    k3_mm, k3_add = n_chunks * (4.0 * br * NB + NB * NB) * width, n_chunks * NB * width
    k4_mm = 3.0 * NB * NB * width
    k3_bytes = 4 * (2 * NB * width + 2 * n_chunks * br * width
                    + n_chunks * (br * NB + NB * NB / 2))
    k4_bytes = 4 * (2 * NB * width + NB * NB)
    if p:
        rec.set_bound(k3, k3_add, k3_bytes, p * k3_mm)
        rec.set_bound(k4, 0.0, k4_bytes, p * k4_mm)
    else:
        rec.set_bound(k3, k3_mm + k3_add, k3_bytes)
        rec.set_bound(k4, k4_mm, k4_bytes)

    # the plans these shapes run on (kernels/chain.py:strip_plan; stage 3's
    # tile is panel_apply.sub_plan's for the stacked couples)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"plan {k3} chunks ({n_chunks} couples of {br} rows, width {width}): "
          f"{chain.strip_plan(NB, width, br, n_chunks, sms, mode)}")
    print(f"plan {k3} heads ({n_head} couples of {NB} rows, LARFB fused): "
          f"{chain.strip_plan(NB, width, NB, n_head, sms, mode, fused=True)}")
    print(f"plan {k4} (width {width}): {chain.strip_plan(NB, width, 0, 0, sms, mode, fused=True)}")
    late_strip(a, rec, card, fac, mode)
    narrow_sweep(a, rec, card, fac, mode)

    c = a.clone()
    strip = c[:NB, NB:]
    sargs = (v_chunks, t2t, c, strip, 0, 1, n_chunks, br, NB, 1)
    lib3, lib4 = libraries
    hi = mode == "highest"
    rec.time(k3, lambda: chain.couple_strip(*sargs, trans=True, **pm),
             lambda: chain.couple_strip_plain(*sargs, trans=True, **pm), lib3 if hi else None,
             10, 3, card)
    rec.time(k4, lambda: chain.larfb_strip(v_stack[0], tg, strip, NB, **pm),
             lambda: chain.larfb_strip_plain(v_stack[0], tg, strip, NB, **pm),
             lib4 if hi else None, 10, 3, card)
    if not hi:  # the split product has no library call: the fp32 one beside it
        fp32_ms(lib3, card, f"{k3} beside torch.ormqr")
        fp32_ms(lib4, card, f"{k4} beside torch.ormqr")
    if p:
        vb, tb = v_chunks.bfloat16(), t2t.bfloat16()
        cb = c[br : br * (1 + n_chunks), NB:].bfloat16().reshape(n_chunks, br, width)
        topb = c[:NB, NB:].bfloat16()

        def k3_chain():
            w = topb + vb.transpose(1, 2) @ cb
            return cb - vb @ (tb.transpose(1, 2) @ w)

        vkb = unit_lower(v_stack[0]).bfloat16()
        tgb = tg.bfloat16()
        bf16_chain_ms(k3_chain, card, k3)
        bf16_chain_ms(lambda: topb - vkb @ (tgb.T @ (vkb.T @ topb)), card, k4)
    del c, strip


def late_strip(a: torch.Tensor, rec: KernelRecord, card: str, fac, mode: str) -> None:
    """K3 at hh panel 27's shape (one couple of 4·nb rows with the LARFB
    fused, a strip of 1024 columns: its plan takes the small tiles and G =
    2), against the plain version of its mode summed in the card's groups;
    bitwise rerun; timed beside the plain version."""
    from tileqr_torch.kernels import chain

    v_stack, tg, _, v_chunks, t2t = fac
    br, width = CHUNK * NB, 4 * NB
    k3 = counter_key("couple_strip", mode)
    plan = chain.strip_plan(NB, width, br, 1,
                            torch.cuda.get_device_properties(0).multi_processor_count, mode,
                            fused=True)
    groups = plan.groups
    args = (v_chunks[:1], t2t[:1])
    geo = dict(trans=True, vkk=v_stack[0], tg=tg, precision=mode)
    outs = []
    for fn, prec, kw in ((chain.couple_strip, mode, {}), (chain.couple_strip, mode, {}),
                         (chain.couple_strip_plain, mode, {"groups": groups}),
                         (chain.couple_strip_plain, "highest", {"groups": groups})):
        c = a[: 2 * br, : NB + width].clone()
        fn(*args, c, c[:NB, NB:], 0, 1, 1, br, NB, 1, **dict(geo, precision=prec), **kw)
        outs.append(c)
    require(torch.equal(outs[0], outs[1]), f"{k3} late panel reruns differ")
    label = f"late panel (1 couple of {br} rows, width {width}, G={groups})"
    print(f"plan {k3} {label}: {plan}")
    compare_mode(rec, "couple_strip", mode, label, outs[0], outs[2], outs[3])
    p = passes_of(mode)
    mm = 4.0 * br * NB * width + NB * NB * width + 3.0 * NB * NB * width
    nbytes = 4 * (2 * NB * width + 2 * br * width + br * NB + NB * NB / 2 + NB * NB)
    bound = rec.bound_of(NB * width, nbytes, p * mm) if p else rec.bound_of(mm + NB * width,
                                                                           nbytes)
    c = outs[0]
    rec.time(k3, lambda: chain.couple_strip(*args, c, c[:NB, NB:], 0, 1, 1, br, NB, 1, **geo),
             lambda: chain.couple_strip_plain(*args, c, c[:NB, NB:], 0, 1, 1, br, NB, 1, **geo),
             None, 20, 3, card, label=label, bound=bound)
    del outs, c


def narrow_sweep(a: torch.Tensor, rec: KernelRecord, card: str, fac, mode: str) -> None:
    """Panel 0's whole K3 sweep (``strip_sweep``: the head couples with the
    LARFB fused, then the chunks) on one column tile, as the hh driver's
    narrow update runs it: its chain on 4 row bands a block
    (``chain.chain_bands``), against the plain version of its mode summed
    in the card's groups; bitwise rerun; timed beside the plain version."""
    from tileqr_torch.kernels import chain

    v_stack, tg, t2h, v_chunks, t2t = fac
    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK
    k3 = counter_key("couple_strip", mode)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = (chain.strip_plan(NB, NB, NB, n_head, sms, mode, fused=True),
             chain.strip_plan(NB, NB, br, n_chunks, sms, mode))

    def sweep(c, prec, plain=False):
        strip = c[:NB, NB:]
        calls = (((v_stack, t2h, c, strip, 1, 1, n_head, NB, NB, 1), plans[0], True),
                 ((v_chunks, t2t, c, strip, 0, 1, n_chunks, br, NB, 1), plans[1], False))
        for args, plan, fused in calls:
            kw = dict(trans=True, vkk=v_stack[0] if fused else None, tg=tg if fused else None,
                      precision=prec)
            if plain:
                chain.couple_strip_plain(*args, groups=plan.groups, **kw)
            else:
                chain.couple_strip(*args, **kw)

    outs = []
    for prec, plain in ((mode, False), (mode, False), (mode, True), ("highest", True)):
        c = a[:, : 2 * NB].clone()
        sweep(c, prec, plain)
        outs.append(c)
    require(torch.equal(outs[0], outs[1]), f"{k3} narrow sweep reruns differ")
    label = (f"narrow update (panel 0's {n_head} heads + {n_chunks} chunks on {NB} columns, "
             f"{plans[0].bands} bands)")
    print(f"plan {k3} {label}: {plans}")
    compare_mode(rec, "couple_strip", mode, label, outs[0], outs[2], outs[3])
    p = passes_of(mode)
    mm = (4.0 * (n_head * NB + n_chunks * br) * NB + (n_head + n_chunks + 3) * NB * NB) * NB
    nbytes = 4 * (2 * NB * NB + 2 * (n_head * NB + n_chunks * br) * NB
                  + (n_head * NB + n_chunks * br) * NB + (n_head + n_chunks + 1) * NB * NB)
    bound = rec.bound_of(NB * NB * (n_head + n_chunks), nbytes, p * mm) if p else rec.bound_of(
        mm + NB * NB * (n_head + n_chunks), nbytes)
    c = outs[0]
    rec.time(k3, lambda: sweep(c, mode), lambda: sweep(c, mode, True), None, 20, 3, card,
             label=label, bound=bound)
    del outs, c


def print_phases(y: torch.Tensor, t: torch.Tensor, win: torch.Tensor, mr: int, mode: str,
                 card: str, label: str) -> None:
    """The whole-panel apply's two phases timed apart on the window (a
    scratch copy: phase 2 updates it), with the plans they run on."""
    from tileqr_torch.kernels import panel_apply as pa

    m, nb = y.shape
    n = win.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tm = t.T.contiguous()
    p1, p2 = pa.project_plan(m, n, nb, mr, sms, mode, True), pa.sub_plan(m, n, nb, sms, mode)
    w = pa._launch_project(y, tm, win, mr, mode, p1)
    t1 = cuda_ms(lambda: pa._launch_project(y, tm, win, mr, mode, p1), 5)
    pa._launch_sub(y, w, win, mode, p2)
    t2 = cuda_ms(lambda: pa._launch_sub(y, w, win, mode, p2), 5)
    print(f"time {label} ({mode}): phase 1 {t1:.4f} ms on {p1}, "
          f"phase 2 {t2:.4f} ms on {p2} [{card}]")


def run_path(a: torch.Tensor, cfg, path: str, card: str):
    """``qr`` on one path with the counts set to 0 just before it and read
    just after; checks the launches of both kernel families."""
    import tileqr_torch
    from tileqr_torch.kernels import _build

    # the hh path runs a panel's K1 and K2 as one pipelined K1 launch
    own = (tuple(k for k in _build.HH_KERNELS if k != "panel_chain") if path == "hh"
           else _build.HR_KERNELS + _build.APPLY_KERNELS)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a guard trip fails the run
        _build.reset_counts()
        q, r = tileqr_torch.qr(a, config=cfg)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        plain = dict(_build.PLAIN_CALLS)
    print(f"{path} path launches {json.dumps(launches)} plain_calls {json.dumps(plain)} "
          f"pipelined {json.dumps(_build.PIPELINE)} exchange {json.dumps(_build.EXCHANGE)}")
    if path == "hh":
        panels = min(a.shape) // NB
        require(_build.PIPELINE["launches"] == launches["panel_factor"] - 1 == panels - 1,
                f"hh: {_build.PIPELINE['launches']} of {launches['panel_factor']} panel "
                f"launches pipelined")
        # every panel launch runs clusters of more than one CTA (K3/K4 and Q
        # run no cluster routine)
        require(_build.EXCHANGE["launches"] == panels,
                f"hh: {_build.EXCHANGE['launches']} of {panels} panel launches exchanged "
                f"partials between CTAs")
    require(all(launches[k] >= 1 for k in own), f"a {path} kernel never launched: {launches}")
    require(not any(v for k, v in launches.items() if k not in own),
            f"the {path} path launched other kernels")
    require(not any(plain.values()), f"a plain version ran on the {path} path: {plain}")
    return launches, q, r


def check_path(a, q, r, cfg, rng, path: str, card: str) -> None:
    """The accuracy checks of one path at its size."""
    import tileqr_torch
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    n = a.shape[0]
    require(tuple(q.shape) == (n, n) and tuple(r.shape) == (n, n), "Q/R shapes")
    require(bool(torch.isfinite(q).all()) and bool(torch.isfinite(r).all()), "non-finite Q/R")
    res = residuals_f64(a, q, r)
    qc, rc = torch.linalg.qr(a)
    ref = residuals_f64(a, qc, rc)
    del qc, rc
    print(f"{path} qr {n}x{n}: explicit-Q residual={res['relerr']:.3e} orth={res['orth']:.3e}; "
          f"cuSOLVER on the same A: residual={ref['relerr']:.3e} orth={ref['orth']:.3e} [{card}]")
    tol_resid = TOL_RELERR if path == "hr" else TOL_RESID
    require(res["relerr"] <= tol_resid, f"explicit-Q residual {res['relerr']:.3e} > {tol_resid}")
    require(res["orth"] <= TOL_ORTH, f"orth {res['orth']:.3e} > {TOL_ORTH}")
    f = tileqr_torch.qr_factor(a, cfg)
    if path == "hr":
        # the hr apply is plain matmuls, so Q^T goes through the factors'
        # reflectors in float64 on the card: the factorization's own error,
        # without the fp32 rounding of a second 64-panel apply
        from tileqr_torch.drivers.square_hr import apply_q_hr

        panels64 = [(y.double(), t.double()) for y, t in f.panels]
        qta = apply_q_hr(panels64, a.double(), f.nb, trans=True)
        del panels64
        relerr = backward_error_f64(a, qta, r)
        del qta
        print(f"{path} qr {n}x{n}: relerr ||Q^T A - R||F/||A||F, Q^T applied in float64 "
              f"= {relerr:.3e} [{card}]")
        rel32 = backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r)
        print(f"{path} qr {n}x{n}: relerr ||Q^T A - R||F/||A||F with the fp32 apply_q "
              f"(B7) = {rel32:.3e} [{card}]")
        require(rel32 <= TOL_RELERR, f"fp32 apply_q relerr {rel32:.3e} > {TOL_RELERR}")
    else:
        relerr = backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r)
        print(f"{path} qr {n}x{n}: relerr ||Q^T A - R||F/||A||F = {relerr:.3e} [{card}]")
    require(relerr <= TOL_RELERR, f"relerr {relerr:.3e} > {TOL_RELERR}")
    if path == "hr":
        h = float(f.health)
        print(f"hr qr {n}x{n}: health (max round-1 orthogonality defect) = {h:.3e}, "
              f"hr_guard_tau {cfg.hr_guard_tau}")
        require(isinstance(f, tileqr_torch.HRFactors) and h <= cfg.hr_guard_tau,
                f"hr health {h:.3e} past tau")
    del f

    def flat(f):
        if path == "hr":
            return [f.r, f.health] + [x for p in f.panels for x in p]
        return [f.packed, f.r_diag, f.t_geqrt] + [x for p in f.panels for x in p]

    t1, t2 = flat(tileqr_torch.qr_factor(a, cfg)), flat(tileqr_torch.qr_factor(a, cfg))
    same = len(t1) == len(t2) and all(torch.equal(x, y) for x, y in zip(t1, t2))
    print(f"{path} qr_factor rerun bitwise equal: {same}")
    require(same, f"{path} qr_factor reruns differ")
    del t1, t2

    b = torch.from_numpy(rng.standard_normal((n, 16), dtype=np.float32)).cuda()
    x = tileqr_torch.lstsq(a, b, cfg)
    a64, x64, b64 = a.double(), x.double(), b.double()
    ne = torch.linalg.norm(a64.T @ (a64 @ x64 - b64)) / (
        torch.linalg.norm(a64) * (torch.linalg.norm(a64) * torch.linalg.norm(x64)
                                  + torch.linalg.norm(b64)))
    ne = float(ne)
    del a64, x64, b64
    print(f"{path} lstsq ({n},16): normal-equation residual {ne:.3e} [{card}]")
    require(np.isfinite(ne) and ne <= TOL_LSTSQ, f"lstsq residual {ne:.3e} > {TOL_LSTSQ}")


def time_path(a: torch.Tensor, cfg, path: str, card: str, reps: int) -> None:
    import tileqr_torch

    n = a.shape[0]
    flops = 2.0 * n * n * (n - n / 3.0)
    tileqr_torch.qr_factor(a, cfg)  # warm, as time_modes does
    ms = cuda_ms(lambda: tileqr_torch.qr_factor(a, cfg), reps)
    print(f"{path} qr_factor {n}x{n}: {ms:.3f} ms, {flops / ms / 1e9:.3f} TFLOP/s [{card}]")
    tileqr_torch.qr(a, config=cfg)
    ms = cuda_ms(lambda: tileqr_torch.qr(a, config=cfg), reps)
    print(f"{path} tileqr_torch.qr {n}x{n} (factor + R + Q): {ms:.3f} ms [{card}]")
    torch.linalg.qr(a, mode="r")
    ms = cuda_ms(lambda: torch.linalg.qr(a, mode="r"), reps)
    print(f"{path} torch.linalg.qr(mode='r') {n}x{n} (cuSOLVER reference): {ms:.3f} ms, "
          f"{flops / ms / 1e9:.3f} TFLOP/s [{card}]")


def phase4(a: torch.Tensor, rec: KernelRecord, card: str) -> None:
    """The hr kernels against their plain versions on a 16384² A."""
    from tileqr_torch.drivers import square_hr
    from tileqr_torch.kernels import modlu, panel_apply, potrf

    # panel 0's gram and Q_top, as hr_panel hands them to B9 and B8
    with square_hr._highest():
        parts = square_hr.hr_panel_parts(a[:, :NB])
    g, q_top = parts["gram"], parts["q_top"]
    del parts

    check_potrf(g, rec, "panel 0 gram (1, 256, 256)")
    shifted = check_modlu(q_top, rec, f"panel 0 Q_top ({NB}, {NB})")

    n = a.shape[0]
    rec.set_bound("potrf_batched", NB ** 3 / 3.0, 4 * 2 * NB * NB)
    rec.set_bound("modified_lu", 2.0 * NB ** 3 / 3.0, 4 * (2 * NB * NB + NB))
    for k in HR_PANELS_TIMED:
        s = k * NB
        with square_hr._highest():
            y, t, _ = square_hr.hr_panel(a[s:, s : s + NB])
        m, w = n - s, n - s - NB
        # phase 1's row-block groups on the card (1 on panel 0, 2 on 48)
        groups = panel_apply.card_project_plan(y, a[s:, s + NB :], panel_apply._block(m, NB, 512),
                                               "highest", fold=True).groups
        outs = []
        for fn, kw in ((panel_apply.panel_apply_carry, {}),
                       (panel_apply.panel_apply_carry_plain, {"groups": groups})):
            c = a.clone()
            with square_hr._highest():
                fn(y, t, c, k, NB, trans=True, **kw)
            outs.append(c)
        require(torch.equal(outs[0][:s], a[:s]) and torch.equal(outs[0][:, : s + NB], a[:, : s + NB]),
                "panel_apply_carry wrote outside its window")
        rec.compare("panel_apply_carry", f"panel {k} window ({m}, {w}) G={groups}",
                    [outs[0][s:, s + NB :]], [outs[1][s:, s + NB :]])
        # B6's library call: ormqr with tau = diag(T) applies the same Qᵀ
        tau = torch.diagonal(t).contiguous()
        win_c = a[s:, s + NB :].contiguous()
        with square_hr._highest():
            lib_rel = rel(torch.ormqr(y, tau, win_c, left=True, transpose=True),
                          outs[1][s:, s + NB :])
        print(f"library panel_apply_carry panel {k}: torch.ormqr(Y, diag(T)) vs plain: "
              f"rel_fro={lib_rel:.3e}")
        require(lib_rel <= TOL_KERNEL, f"ormqr differs from panel_apply_carry: {lib_rel:.3e}")
        del outs
        flops = 4.0 * m * NB * w + 2.0 * NB * NB * w
        nbytes = 4 * (m * NB + NB * NB + 2 * m * w)
        c = a.clone()
        win = c[s:, s + NB :]

        def chain3():
            win.sub_(y @ (t.T @ (y.T @ win)))

        with square_hr._highest():
            if k == 0:
                rec.set_bound("panel_apply_carry", flops, nbytes)
                rec.time("panel_apply_carry",
                         lambda: panel_apply.panel_apply_carry(y, t, c, k, NB),
                         lambda: panel_apply.panel_apply_carry_plain(y, t, c, k, NB),
                         lambda: torch.ormqr(y, tau, win_c, left=True, transpose=True),
                         5, 2, card)
            else:
                kms = cuda_ms(lambda: panel_apply.panel_apply_carry(y, t, c, k, NB), 10)
                torch.ormqr(y, tau, win_c, left=True, transpose=True)
                lms = cuda_ms(lambda: torch.ormqr(y, tau, win_c, left=True, transpose=True), 5)
                b_ms = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
                print(f"time panel_apply_carry panel {k} ({m}, {w}): kernel {kms:.4f} ms, "
                      f"library (torch.ormqr) {lms:.4f} ms, bound {b_ms:.4f} ms (operations) "
                      f"[{card}]")
            chain3()
            torch.cuda.synchronize()
            print(f"time panel_apply_carry panel {k}: three-torch.matmul chain "
                  f"{cuda_ms(chain3, 5):.4f} ms [{card}]")
            print_phases(y, t, win, panel_apply._block(m, NB, 512), "highest", card,
                         f"panel_apply_carry panel {k}")
        del c, win, win_c

    with square_hr._highest():
        rec.time("potrf_batched", lambda: potrf.potrf_batched(g),
                 lambda: potrf.potrf_batched_plain(g),
                 lambda: torch.linalg.cholesky(g, upper=True), 20, 2, card)
        rec.time("modified_lu", lambda: modlu.modified_lu(q_top),
                 lambda: modlu.modified_lu_plain(q_top),
                 lambda: torch.linalg.lu_factor(shifted, pivot=False), 20, 2, card)
    print_modlu_plan(NB)


def check_potrf(g: torch.Tensor, rec: KernelRecord, label: str) -> None:
    """B9 on g against its plain version (the same per-entry operations),
    zeros below the diagonal, rerun bitwise; prints its cluster."""
    from tileqr_torch.kernels import potrf

    got, want = potrf.potrf_batched(g), potrf.potrf_batched_plain(g)
    rec.compare("potrf_batched", label, [got], [want])
    same = torch.equal(got, potrf.potrf_batched(g))
    print(f"kernel potrf_batched {label}: rerun bitwise equal: {same}, "
          f"zeros below the diagonal: {not bool(torch.tril(got, -1).any())}")
    require(same and not torch.tril(got, -1).any(), f"potrf_batched reruns or zeros ({label})")
    b, n, _ = g.shape
    plan = potrf.potrf_plan(b, n, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"cluster potrf_batched ({b}, {n}, {n}): C={plan.ctas} CTAs a matrix, blocks of 16 rows "
          f"dealt cyclically, {plan.smem_bytes} shared bytes per CTA, blocks resident in shared "
          f"memory: {plan.resident}")


def potrf_bound(b: int, n: int):
    """(ms, binds) of B9 on a (b, n, n) stack: n³/3 FMA-pairs each, read G,
    write R."""
    return KernelRecord.bound_of(b * n ** 3 / 3.0, 4.0 * 2 * b * n * n)


def check_modlu(q_top: torch.Tensor, rec: KernelRecord, label: str) -> torch.Tensor:
    """B8 on q_top against its plain version (d bitwise equal), rerun
    bitwise; returns Q_top − diag(d), the input of its library call."""
    from tileqr_torch.kernels import modlu

    got, want = modlu.modified_lu(q_top), modlu.modified_lu_plain(q_top)
    require(torch.equal(got[1], want[1]), f"modified_lu signs differ from the plain version ({label})")
    rec.compare("modified_lu", label, [got[0]], [want[0]])
    again = modlu.modified_lu(q_top)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    print(f"kernel modified_lu {label}: rerun bitwise equal: {same}")
    require(same, f"modified_lu reruns differ ({label})")
    # B8's library call: LU without pivoting of Q_top − diag(d), d taken
    # from the modified LU (the one choice the library cannot make)
    shifted = q_top - torch.diag(want[1])
    lib_rel = rel(torch.linalg.lu_factor(shifted, pivot=False)[0], want[0])
    print(f"library modified_lu {label}: lu_factor(Q_top - diag(d), pivot=False) vs plain: "
          f"rel_fro={lib_rel:.3e}")
    require(lib_rel <= TOL_KERNEL, f"lu_factor(pivot=False) differs: {lib_rel:.3e}")
    return shifted


def print_modlu_plan(nb: int) -> None:
    """The thread-block cluster B8 runs on at nb (``modlu_plan``)."""
    from tileqr_torch.kernels.modlu import modlu_plan

    plan = modlu_plan(nb)
    print(f"cluster modified_lu nb={nb}: C={plan.ctas} CTAs of {-(-nb // plan.ctas)} columns, "
          f"panels of ib={plan.ib}, {plan.smem_bytes} shared bytes per CTA, "
          f"block resident in shared memory: {plan.resident}")


def modlu_nb512(a: torch.Tensor, rec: KernelRecord, card: str) -> None:
    """B9 on the tsqr factor's one panel's gram and B8 on its Q_top (nb =
    512), as ``hr_panel`` hands them over: against their plain versions,
    timed beside them, their bounds and ``torch.linalg.cholesky`` and
    ``lu_factor``."""
    from tileqr_torch.drivers import square_hr
    from tileqr_torch.kernels import modlu

    from tileqr_torch.kernels import potrf

    with square_hr._highest():
        parts = square_hr.hr_panel_parts(a)
        q_top, g = parts["q_top"], parts["gram"]
        del parts
        nb = q_top.shape[0]
        check_potrf(g, rec, f"tsqr factor gram (1, {nb}, {nb})")
        rec.time("potrf_batched", lambda: potrf.potrf_batched(g),
                 lambda: potrf.potrf_batched_plain(g),
                 lambda: torch.linalg.cholesky(g, upper=True), 20, 1, card,
                 label=f"(1, {nb}, {nb}) (tsqr cholqr2 factor's gram)", bound=potrf_bound(1, nb))
        shifted = check_modlu(q_top, rec, f"tsqr factor Q_top ({nb}, {nb})")
        rec.time("modified_lu", lambda: modlu.modified_lu(q_top),
                 lambda: modlu.modified_lu_plain(q_top),
                 lambda: torch.linalg.lu_factor(shifted, pivot=False), 20, 1, card,
                 label=f"nb={nb} (tsqr factor Q_top)",
                 bound=rec.bound_of(2.0 * nb ** 3 / 3.0, 4 * (2 * nb * nb + nb)))
    print_modlu_plan(nb)
    torch.cuda.empty_cache()


def sign_fixed_rel(r: torch.Tensor, ref: torch.Tensor) -> float:
    """‖R − R_ref‖F/‖R_ref‖F after matching R's row signs to R_ref's."""
    s = torch.sign(torch.diagonal(r)) * torch.sign(torch.diagonal(ref))
    s[s == 0] = 1
    return rel(r * s[:, None], ref)


def run_counted(fn, own: tuple, expect: dict, what: str):
    """fn() with the counts set to 0 just before and read just after:
    ``own`` kernels must launch (as often as ``expect`` says, where it
    does), every other kernel and every plain version must not."""
    from tileqr_torch.kernels import _build

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a guard trip fails the run
        _build.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    print(f"{what} launches {json.dumps(launches)} plain_calls {json.dumps(plain)}")
    require(all(launches[k] >= 1 for k in own), f"{what}: a kernel never launched: {launches}")
    require(all(launches[k] == v for k, v in expect.items()), f"{what}: launches {launches}")
    require(not any(v for k, v in launches.items() if k not in own),
            f"{what} launched other kernels: {launches}")
    require(not any(plain.values()), f"a plain version ran in {what}: {plain}")
    return out, launches


def geqrt_bound(b: int, m: int, n: int):
    """(ms, binds) of GEQRT on a (b, m, n) stack: read A, write packed and T."""
    return KernelRecord.bound_of(b * geqrf_flops(m, n), 4.0 * b * (2 * m * n + n * n))


def geqrt_route(b: int, m: int, n: int, ib: int = IB) -> str:
    """The counter of the route the wrapper takes for a (b, m, n) stack."""
    from tileqr_torch.kernels import geqrt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return geqrt.ROUTE_KEYS[geqrt.batched_plan(b, m, n, ib, sms).route]


def tree_levels(rec: KernelRecord, rs: torch.Tensor, p: int, n: int, lr: int, card: str) -> list:
    """Each level of the tsqr tree on the stack tsqr_factor forms from the
    R factors below (rs: the leaves' R), against the plain version, rerun
    bitwise, timed beside the one-block kernel on the same stack and
    ``torch.geqrf``; the level of 32 stacks is the cluster route's row,
    level 1 (128 stacks) the tall route's. Returns each level's route."""
    from tileqr_torch.drivers import tsqr as dtsqr
    from tileqr_torch.kernels import geqrt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes = []
    for ncomb, a_l, _, rem in dtsqr._tree_plan(p, n, lr, 8):
        stack = rs[: ncomb * a_l].reshape(ncomb, a_l * n, n)
        plan = geqrt.batched_plan(ncomb, a_l * n, n, IB, sms)
        key = geqrt.ROUTE_KEYS[plan.route]
        routes.append(key)
        label = f"tsqr level {tuple(stack.shape)} ib={IB} C={plan.ctas}"
        got = geqrt.geqrt_batched(stack, IB)
        rec.compare(key, label, got, geqrt.geqrt_batched_plain(stack, IB))
        same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt_batched(stack, IB)))
        print(f"kernel {key} {label}: rerun bitwise equal: {same}")
        require(same, f"{key} reruns differ ({label})")
        bound = geqrt_bound(ncomb, a_l * n, n)
        if plan.route == "cluster" and ncomb == 32:
            rec.bound[key] = bound
            rec.time(key, lambda: geqrt.geqrt_batched(stack, IB),
                     lambda: geqrt.geqrt_batched_plain(stack, IB), lambda: torch.geqrf(stack),
                     3, 1, card)
        else:
            rec.time(key, lambda: geqrt.geqrt_batched(stack, IB),
                     lambda: geqrt.geqrt_batched_plain(stack, IB), lambda: torch.geqrf(stack),
                     3, 1, card, label=label, bound=bound)
        if plan.route in ("cluster", "tall"):
            geqrt._geqrt_one_block(stack, IB)
            print(f"time geqrt_batched {label}: the one-block kernel on the same stack "
                  f"{cuda_ms(lambda: geqrt._geqrt_one_block(stack, IB), 2):.4f} ms [{card}]")
        rnew = torch.triu(got[0][:, :n])
        rs = torch.cat([rnew, rs[ncomb * a_l :]]) if rem else rnew
        del got, stack
    torch.cuda.empty_cache()
    return routes


def tsqr_factor_b3(a: torch.Tensor, f, rf: torch.Tensor, rec: KernelRecord, card: str) -> int:
    """``apply_q`` in "b3" of the tsqr factor's one nb = 512 panel to A's
    512 columns, with the counts set to 0 just before and read just after:
    one launch of B7's split instantiation (nb-aligned, so no matmul
    route), relerr ≤ the b3 limit; then B7 at that shape against its b3 and
    "highest" plain versions, and timed. Returns the launches."""
    import tileqr_torch
    from tileqr_torch.drivers.square_hr import _highest
    from tileqr_torch.kernels import panel_apply as pa
    from tileqr_torch.utils.verify import backward_error_f64

    m, n = a.shape
    b7 = counter_key("panel_apply", "b3")
    cfg = tileqr_torch.QRConfig(nb=NB_TS, precision="b3")
    qta, launches = run_counted(lambda: tileqr_torch.apply_q(f, a, trans=True, config=cfg),
                                (b7,), {b7: 1}, "tsqr factor apply_q precision=b3")
    relerr = backward_error_f64(a, qta, rf)
    del qta
    print(f"tsqr cholqr2 {m}x{n}: relerr with apply_q in b3 (B7, nb={f.nb}) = {relerr:.3e} "
          f"[{card}]")
    require(relerr <= TOL_MODE_RELERR["b3"], f"tsqr factor b3 apply_q relerr {relerr:.3e}")
    y, t = f.panels[0]
    nb = y.shape[1]
    mr = pa._block(m, nb, 1024)
    plan = pa.card_project_plan(y, a, mr, "b3", fold=True)
    groups = plan.groups
    tm = t.T.contiguous()
    with _highest():
        # phase 1 alone: its plan runs the row blocks in G > 1 groups here
        # (W's 32 tiles leave most SMs idle); held to the plain sums in the
        # same groups
        compare_mode(rec, "panel_apply", "b3",
                     f"tsqr factor phase 1 ({m}, {n}) nb={nb} G={groups}",
                     pa._launch_project(y, tm, a, mr, "b3", plan),
                     tm @ pa._project_plain(y, a, mr, "b3", groups),
                     tm @ pa._project_plain(y, a, mr, "highest", groups))
        outs = []
        for fn, prec in ((pa.panel_apply, "b3"), (pa.panel_apply_plain, "b3"),
                         (pa.panel_apply_plain, "highest")):
            kw = {} if fn is pa.panel_apply else {"groups": groups}
            outs.append(fn(y, t, a.clone(), trans=True, precision=prec, **kw))
        compare_mode(rec, "panel_apply", "b3", f"tsqr factor ({m}, {n}) nb={nb}", *outs)
        del outs
        c = a.clone()
        bound = rec.bound_of(2.0 * nb * nb * n, 4 * (m * nb + nb * nb + 2 * m * n),
                             3 * 4.0 * m * nb * n)
        rec.time(b7, lambda: pa.panel_apply(y, t, c, precision="b3"),
                 lambda: pa.panel_apply_plain(y, t, c, precision="b3", groups=groups), None, 3, 1,
                 card, label=f"tsqr factor ({m}, {n}) nb={nb}", bound=bound)
        w = pa._launch_project(y, tm, c, mr, "b3", plan)
        p1 = cuda_ms(lambda: pa._launch_project(y, tm, c, mr, "b3", plan), 3)
        p2 = cuda_ms(lambda: pa._sub_on_card(y, w, c, "b3"), 3)
        print(f"time {b7} tsqr factor ({m}, {n}) nb={nb}: phase 1 (G={groups}) {p1:.4f} ms, "
              f"phase 2 {p2:.4f} ms [{card}]")
        del c, w
    torch.cuda.empty_cache()
    return launches[b7]


def phase7(rec: KernelRecord, rng, card: str):
    """The tall-skinny path at config 3; returns the batched GEQRT's
    launches in its ``tsqr`` run and B7's in the b3 ``apply_q`` of the
    tsqr factor."""
    import tileqr_torch
    from tileqr_torch.drivers import tsqr as dtsqr
    from tileqr_torch.drivers.square_hr import apply_q_hr
    from tileqr_torch.kernels import geqrt
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    m, n = M_TS, N_TS
    cfg = tileqr_torch.QRConfig(nb=NB_TS)
    a = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).cuda()
    lr = dtsqr.auto_leaf_rows(m, n)
    p = m // lr
    leaves = a.view(p, lr, n)

    # the kernel on the leaves (the tall route), and on each level's stack
    # as tsqr_factor forms it from the R factors below
    leaf_key = geqrt_route(p, lr, n)
    tall = geqrt.tall_plan(p, lr, n, IB, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"route geqrt_batched tsqr leaves ({p}, {lr}, {n}): {leaf_key}, {tall}")
    require(leaf_key == "geqrt_batched[tall]", f"the leaves take {leaf_key}")
    got = geqrt.geqrt_batched(leaves, IB)
    want = geqrt.geqrt_batched_plain(leaves, IB)
    rec.compare(leaf_key, f"tsqr leaves ({p}, {lr}, {n}) ib={IB}", got, want)
    del want
    same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt_batched(leaves, IB)))
    print(f"kernel {leaf_key} tsqr leaves: rerun bitwise equal: {same}")
    require(same, "the leaves' reruns differ")
    rs = torch.triu(got[0].view(p, lr, n)[:, :n])
    del got
    torch.cuda.empty_cache()
    routes = tree_levels(rec, rs, p, n, lr, card)
    del rs
    torch.cuda.empty_cache()
    rec.bound[leaf_key] = geqrt_bound(p, lr, n)
    rec.time(leaf_key, lambda: geqrt.geqrt_batched(leaves, IB),
             lambda: geqrt.geqrt_batched_plain(leaves, IB), lambda: torch.geqrf(leaves),
             3, 1, card)
    geqrt._geqrt_one_block(leaves, IB)
    print(f"time geqrt_batched tsqr leaves ({p}, {lr}, {n}): the one-block kernel on the same "
          f"stack {cuda_ms(lambda: geqrt._geqrt_one_block(leaves, IB), 1):.4f} ms [{card}]")
    torch.cuda.empty_cache()

    # the path: tsqr r (auto → tree): the leaves and every level, each on
    # the route its plan picks
    route_of = geqrt_route(p, lr, n)
    expect = {k: ([route_of] + routes).count(k) for k in TS_KERNELS}
    require(expect["geqrt_batched[tall]"] == 2 and expect["geqrt_batched[cluster]"] == 4,
            f"tsqr r's routes: {expect}")
    r, launches = run_counted(lambda: tileqr_torch.tsqr(a, "r", cfg),
                              tuple(k for k in TS_KERNELS if expect[k]), expect,
                              "tsqr r (auto → tree)")
    require(tuple(r.shape) == (n, n) and bool(torch.isfinite(r).all()), "tsqr R shape/finite")
    same = torch.equal(r, tileqr_torch.tsqr(a, "r", cfg))
    print(f"tsqr r rerun bitwise equal: {same}")
    require(same, "tsqr r reruns differ")
    rc = torch.linalg.qr(a, mode="r")[1]
    print(f"tsqr {m}x{n}: R vs torch.linalg.qr's R (row signs matched): "
          f"rel_fro={sign_fixed_rel(r, rc):.3e} [{card}]")
    del rc
    f = tileqr_torch.tsqr(a, "factor", cfg, strategy="tree")
    require(isinstance(f, tileqr_torch.TSQRFactors) and torch.equal(f.r[:n, :n], r),
            "tree TSQRFactors differ from tsqr r")
    relerr = backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r)
    print(f"tsqr tree {m}x{n}: relerr ||Q^T A - [R; 0]||F/||A||F = {relerr:.3e} [{card}]")
    require(relerr <= TOL_RELERR, f"tsqr relerr {relerr:.3e} > {TOL_RELERR}")
    del f
    torch.cuda.empty_cache()
    q, r2 = tileqr_torch.tsqr(a, "reduced", cfg)
    require(tuple(q.shape) == (m, n) and torch.equal(r2, r), "tsqr reduced Q shape / R")
    res = residuals_f64(a, q, r2)
    print(f"tsqr tree {m}x{n}: explicit-Q residual={res['relerr']:.3e} orth={res['orth']:.3e} "
          f"[{card}]")
    require(res["relerr"] <= TOL_RESID and res["orth"] <= TOL_ORTH, f"tsqr reduced: {res}")
    del q, r2
    torch.cuda.empty_cache()

    # tsqr factor (auto → cholqr2 → HRFactors)
    f, _ = run_counted(lambda: tileqr_torch.tsqr(a, "factor", cfg),
                       ("potrf_batched", "modified_lu"), {}, "tsqr factor (auto → cholqr2)")
    h = float(f.health)
    print(f"tsqr factor {m}x{n}: HRFactors health {h:.3e}, hr_guard_tau {cfg.hr_guard_tau}")
    require(isinstance(f, tileqr_torch.HRFactors) and f.nb == n and h <= cfg.hr_guard_tau,
            f"tsqr factor health {h:.3e}")
    rf = f.r[:n, :n]
    panels64 = [(y.double(), t.double()) for y, t in f.panels]
    rel64 = backward_error_f64(a, apply_q_hr(panels64, a.double(), f.nb, trans=True), rf)
    del panels64
    print(f"tsqr cholqr2 {m}x{n}: relerr, Q^T applied in float64 = {rel64:.3e} [{card}]")
    require(rel64 <= TOL_RELERR, f"tsqr cholqr2 relerr {rel64:.3e} > {TOL_RELERR}")
    rel32 = backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), rf)
    verdict = ("within the 1e-6 target" if rel32 <= TOL_RELERR else
               f"SHORTFALL against the 1e-6 target (regression bound {TOL_RESID})")
    print(f"tsqr cholqr2 {m}x{n}: relerr with the fp32 apply_q = {rel32:.3e}: {verdict} [{card}]")
    require(rel32 <= TOL_RESID, f"tsqr cholqr2 fp32 apply_q relerr {rel32:.3e} > {TOL_RESID}")
    b7_launches = tsqr_factor_b3(a, f, rf, rec, card)
    del f, rf
    torch.cuda.empty_cache()
    modlu_nb512(a, rec, card)

    flops = 2.0 * n * n * (m - n / 3.0)
    c16 = torch.from_numpy(rng.standard_normal((m, 16), dtype=np.float32)).cuda()

    def factor_apply():
        return tileqr_torch.apply_q(tileqr_torch.tsqr(a, "factor", cfg), c16, trans=True)

    for label, fn in (("tsqr r (tree)", lambda: tileqr_torch.tsqr(a, "r", cfg)),
                      ("tsqr factor (cholqr2)", lambda: tileqr_torch.tsqr(a, "factor", cfg)),
                      ("tsqr factor + apply_q (16 columns)", factor_apply),
                      ("torch.linalg.qr(mode='r') (cuSOLVER reference)",
                       lambda: torch.linalg.qr(a, mode="r"))):
        fn()
        t = cuda_ms(fn, 3)
        print(f"{label} {m}x{n}: {t:.3f} ms, {flops / t / 1e9:.3f} TFLOP/s [{card}]")
    del a, leaves, c16
    torch.cuda.empty_cache()
    return {k: launches[k] for k in TS_KERNELS}, b7_launches


def batched_gates(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor, what: str, card: str):
    a64, q64, r64 = a.double(), q.double(), r.double()
    res = torch.linalg.norm(a64 - q64 @ r64, dim=(1, 2)) / torch.linalg.norm(a64, dim=(1, 2))
    eye = torch.eye(q.shape[2], dtype=torch.float64, device=q.device)
    orth = torch.linalg.norm(q64.transpose(1, 2) @ q64 - eye, dim=(1, 2))
    res, orth = float(res.max()), float(orth.max())
    print(f"{what}: max residual ||A-QR||F/||A||F {res:.3e}, max orth {orth:.3e} [{card}]")
    require(res <= TOL_RELERR and orth <= TOL_ORTH, f"{what}: residual {res:.3e} orth {orth:.3e}")


def one_block(rec: KernelRecord, card: str) -> None:
    """The one-block kernel at a stack it keeps, wide matrices past the
    small route (m < n, which neither the cluster nor the tall route
    takes): against its plain version, rerun bitwise, timed beside
    ``torch.geqrf``. No path runs it. Its stack comes from a generator of
    its own, so the phases after it draw from the shared stream what they
    drew before this check was added."""
    from tileqr_torch.kernels import geqrt

    rng = np.random.default_rng(12)
    b, m, n = 64, 256, 512
    key = geqrt_route(b, m, n)
    require(key == "geqrt_batched", f"a wide ({b}, {m}, {n}) stack takes {key}")
    a = torch.from_numpy(rng.standard_normal((b, m, n), dtype=np.float32)).cuda()
    label = f"wide stack ({b}, {m}, {n}) ib={IB}"
    got = geqrt.geqrt_batched(a, IB)
    rec.compare(key, label, got, geqrt.geqrt_batched_plain(a, IB))
    same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt_batched(a, IB)))
    print(f"kernel {key} {label}: rerun bitwise equal: {same}")
    require(same, f"{key} reruns differ ({label})")
    rec.bound[key] = geqrt_bound(b, m, n)
    rec.time(key, lambda: geqrt.geqrt_batched(a, IB), lambda: geqrt.geqrt_batched_plain(a, IB),
             lambda: torch.geqrf(a), 5, 1, card)
    del a, got
    torch.cuda.empty_cache()


def tall_tiles(rec: KernelRecord, card: str) -> None:
    """The tall route on 4096 matrices of 256², a ``qr_batched`` stack
    past the small route: against its plain version, rerun bitwise, timed
    beside its bound, ``torch.geqrf`` and the one-block kernel on the
    same stack. Its stack comes from a generator of its own, so the phases
    after it draw from the shared stream what they drew before."""
    from tileqr_torch.kernels import geqrt

    rng = np.random.default_rng(13)
    b, n = 4096, 2 * N_BA
    key = geqrt_route(b, n, n)
    require(key == "geqrt_batched[tall]", f"a ({b}, {n}, {n}) stack takes {key}")
    a = torch.from_numpy(rng.standard_normal((b, n, n), dtype=np.float32)).cuda()
    label = f"qr_batched's ({b}, {n}, {n}) ib={IB}"
    got = geqrt.geqrt_batched(a, IB)
    rec.compare(key, label, got, geqrt.geqrt_batched_plain(a, IB))
    same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt_batched(a, IB)))
    print(f"kernel {key} {label}: rerun bitwise equal: {same}")
    require(same, f"{key} reruns differ ({label})")
    del got
    rec.time(key, lambda: geqrt.geqrt_batched(a, IB), lambda: geqrt.geqrt_batched_plain(a, IB),
             lambda: torch.geqrf(a), 5, 1, card, label=label, bound=geqrt_bound(b, n, n))
    geqrt._geqrt_one_block(a, IB)
    print(f"time geqrt_batched {label}: the one-block kernel on the same stack "
          f"{cuda_ms(lambda: geqrt._geqrt_one_block(a, IB), 3):.4f} ms [{card}]")
    del a
    torch.cuda.empty_cache()


def phase8(rec: KernelRecord, rng, card: str) -> int:
    """The batched path at config 4; returns the small route's launches in
    its ``qr_batched`` run."""
    import tileqr_torch
    from tileqr_torch.drivers import cholqr
    from tileqr_torch.kernels import _build, geqrt, potrf

    b, n = B_BA, N_BA
    hh = tileqr_torch.QRConfig()
    a = torch.from_numpy(rng.standard_normal((b, n, n), dtype=np.float32)).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # B11 (ib 32, the path's) and B16 (ib 128) on the small route, a CTA a
    # matrix: against the plain version, rerun bitwise, each block's T
    # against the recurrence (t_from_gram) on the kernel's own reflectors
    rec.bound["geqrt_batched[small]"] = geqrt_bound(b, n, n)
    for ib in (hh.batched_ib, IB):
        plan = geqrt.batched_plan(b, n, n, ib, sms)
        key = geqrt.ROUTE_KEYS[plan.route]
        label = f"batch ({b}, {n}, {n}) ib={ib}"
        print(f"route geqrt_batched {label}: {plan.route} ({key}), {plan.threads} threads a CTA, "
              f"{plan.smem_bytes} shared bytes, "
              f"{_build.lib().tq_geqrt_small_per_sm(n, n, ib, plan.threads)} CTAs an SM")
        require(key == "geqrt_batched[small]", f"{label} takes the {plan.route} route")
        got = geqrt.geqrt_batched(a, ib)
        rec.compare(key, label, got, geqrt.geqrt_batched_plain(a, ib))
        same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt_batched(a, ib)))
        print(f"kernel {key} {label}: rerun bitwise equal: {same}")
        require(same, f"{key} reruns differ ({label})")
        v = (torch.tril(got[0], -1) + torch.eye(n, device=a.device)).double()
        worst = 0.0
        for s0 in range(0, n, ib):
            e0 = min(s0 + ib, n)
            vb = v[:, :, s0:e0]
            tau = torch.diagonal(got[1][:, s0:e0, s0:e0], dim1=1, dim2=2).double()
            worst = max(worst, rel(got[1][:, s0:e0, s0:e0],
                                   geqrt.t_from_gram(vb.transpose(1, 2) @ vb, tau)))
        print(f"kernel {key} {label}: T blocks vs t_from_gram of its reflectors: "
              f"rel_fro={worst:.3e}")
        require(worst <= TOL_KERNEL, f"{key} T blocks differ from the recurrence: {worst:.3e}")
        del got, v
        kw = {} if ib == hh.batched_ib else {"label": label, "bound": geqrt_bound(b, n, n)}
        rec.time(key, lambda: geqrt.geqrt_batched(a, ib),
                 lambda: geqrt.geqrt_batched_plain(a, ib), lambda: torch.geqrf(a),
                 5, 1, card, **kw)
    # B1s: geqrt on one 256² tile, the B = 1 stack (the cluster route where
    # its plan takes one), timed beside the one-block kernel on the same tile
    tile = torch.from_numpy(rng.standard_normal((2 * n, 2 * n), dtype=np.float32)).cuda()
    key = geqrt_route(1, 2 * n, 2 * n)
    label = f"B1s geqrt one (256, 256) tile ib=128 ({key})"
    got = geqrt.geqrt(tile)
    rec.compare(key, label, got, [x[0] for x in geqrt.geqrt_batched_plain(tile[None], IB)])
    same = all(torch.equal(x, y) for x, y in zip(got, geqrt.geqrt(tile)))
    print(f"kernel {key} {label}: rerun bitwise equal: {same}")
    require(same, "geqrt reruns differ")
    rec.time(key, lambda: geqrt.geqrt(tile),
             lambda: geqrt.geqrt_batched_plain(tile[None], IB), lambda: torch.geqrf(tile),
             20, 2, card, label=label, bound=geqrt_bound(1, 2 * n, 2 * n))
    print(f"time geqrt_batched {label}: the one-block kernel on the same tile "
          f"{cuda_ms(lambda: geqrt._geqrt_one_block(tile[None], IB), 10):.4f} ms [{card}]")
    one_block(rec, card)
    tall_tiles(rec, card)

    (q, r), launches = run_counted(lambda: tileqr_torch.qr_batched(a, config=hh),
                                   ("geqrt_batched[small]",), {"geqrt_batched[small]": 1},
                                   "qr_batched (hh)")
    batched_gates(a, q, r, f"qr_batched hh ({b}, {n}, {n})", card)
    q2, r2 = tileqr_torch.qr_batched(a, config=hh)
    same = torch.equal(q, q2) and torch.equal(r, r2)
    print(f"qr_batched rerun bitwise equal: {same}")
    require(same, "qr_batched reruns differ")
    del q, r, q2, r2

    ch = tileqr_torch.QRConfig(batched_method="cholqr2")
    h = float(cholqr.cholqr2_batched(a, mode="r", stats=True)[1])
    print(f"cholqr2 on the gaussian stack: health {h:.3e} (tau {ch.hr_guard_tau})")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        q, r = tileqr_torch.qr_batched(a, config=ch)
    require(any("hr guard" in str(w.message) for w in caught),
            "the cholqr2 guard did not trip on the gaussian stack")
    batched_gates(a, q, r, "qr_batched cholqr2 → guard → hh fallback", card)
    del q, r
    eye = torch.eye(n, device=a.device)
    wc = a + 4 * float(np.sqrt(n)) * eye
    h = float(cholqr.cholqr2_batched(wc, mode="r", stats=True)[1])
    print(f"cholqr2 on G + 4*sqrt({n})*I: health {h:.3e} (tau {ch.hr_guard_tau})")
    require(h <= ch.hr_guard_tau, f"well-conditioned stack health {h:.3e}")
    # B9 on that stack's gram, as cholqr2_batched hands it over: C = 1, a
    # matrix a CTA
    with cholqr._highest():
        g = cholqr.bdot_pair_rows(wc, wc)
    check_potrf(g, rec, f"qr_batched cholqr2 gram ({b}, {n}, {n})")
    with cholqr._highest():
        rec.time("potrf_batched", lambda: potrf.potrf_batched(g),
                 lambda: potrf.potrf_batched_plain(g),
                 lambda: torch.linalg.cholesky(g, upper=True), 10, 1, card,
                 label=f"({b}, {n}, {n}) (qr_batched cholqr2 gram)", bound=potrf_bound(b, n))
    del g
    (q, r), _ = run_counted(lambda: tileqr_torch.qr_batched(wc, config=ch), ("potrf_batched",),
                            {"potrf_batched": 1}, "qr_batched (cholqr2, well-conditioned)")
    batched_gates(wc, q, r, "qr_batched cholqr2 (well-conditioned)", card)
    del q, r

    flops = b * 2.0 * n * n * (n - n / 3.0)
    for label, x, fn in (
            ("qr_batched hh", a, lambda: tileqr_torch.qr_batched(a, config=hh)),
            ("qr_batched cholqr2 (well-conditioned stack)", wc,
             lambda: tileqr_torch.qr_batched(wc, config=ch)),
            ("torch.linalg.qr (reduced)", a, lambda: torch.linalg.qr(a)),
            ("torch.linalg.qr (reduced, well-conditioned stack)", wc,
             lambda: torch.linalg.qr(wc))):
        fn()
        t = cuda_ms(fn, 5)
        print(f"{label} ({b}, {n}, {n}): {t:.3f} ms, {flops / t / 1e9:.3f} TFLOP/s [{card}]")
    del a, wc, tile
    torch.cuda.empty_cache()
    return launches["geqrt_batched[small]"]


def panel_pair(a: torch.Tensor, k: int):
    """(Y, T) of panel k of A by the fp32 hr panel, as the driver makes them."""
    from tileqr_torch.drivers import square_hr

    s = k * NB
    with square_hr._highest():
        y, t, _ = square_hr.hr_panel(a[s:, s : s + NB])
    return y, t


def apply_kernels(a: torch.Tensor, rec: KernelRecord, card: str, mode: str) -> None:
    """B6 on panels 0 and 48 (emulated modes) and B7 on orgqr's k = 0 and
    k = 63 windows, against the plain versions of the same mode, with
    bounds and times at panel 0 and the k = 0 window."""
    from tileqr_torch.drivers.square_hr import _highest
    from tileqr_torch.kernels import panel_apply as pa

    n, p = a.shape[0], passes_of(mode)
    pm = dict(precision=mode)

    def bound(name, m, w):
        mm, fold = 4.0 * m * NB * w, 2.0 * NB * NB * w
        nbytes = 4 * (m * NB + NB * NB + 2 * m * w)
        if p:
            return rec.bound_of(fold, nbytes, p * mm)
        return rec.bound_of(mm + fold, nbytes)

    def chain_fn(y, t, win):
        yb, tb, cb = y.bfloat16(), t.bfloat16(), win.bfloat16()
        return lambda: cb - yb @ (tb.T @ (yb.T @ cb))

    with _highest():
        if mode != "highest":
            b6 = counter_key("panel_apply_carry", mode)
            for k in HR_PANELS_TIMED:
                s = k * NB
                y, t = panel_pair(a, k)
                m, w = n - s, n - s - NB
                groups = pa.card_project_plan(y, a[s:, s + NB :], pa._block(m, NB, 512), mode,
                                              fold=True).groups
                outs = []
                for fn, prec in ((pa.panel_apply_carry, mode), (pa.panel_apply_carry_plain, mode),
                                 (pa.panel_apply_carry_plain, "highest")):
                    c = a.clone()
                    kw = {} if fn is pa.panel_apply_carry else {"groups": groups}
                    fn(y, t, c, k, NB, trans=True, precision=prec, **kw)
                    outs.append(c[s:, s + NB :])
                compare_mode(rec, "panel_apply_carry", mode,
                             f"panel {k} window ({m}, {w}) G={groups}", *outs)
                del outs
                c = a.clone()
                if k == 0:
                    rec.bound[b6] = bound(b6, m, w)
                    rec.time(b6, lambda: pa.panel_apply_carry(y, t, c, k, NB, **pm),
                             lambda: pa.panel_apply_carry_plain(y, t, c, k, NB, **pm),
                             None, 5, 2, card)
                else:
                    rec.time(b6, lambda: pa.panel_apply_carry(y, t, c, k, NB, **pm),
                             lambda: pa.panel_apply_carry_plain(y, t, c, k, NB, **pm), None,
                             10, 2, card, label=f"panel {k} ({m}, {w})", bound=bound(b6, m, w))
                bf16_chain_ms(chain_fn(y, t, c[s:, s + NB :]), card, f"{b6} panel {k}")
                print_phases(y, t, c[s:, s + NB :], pa._block(m, NB, 512), mode, card,
                             f"{b6} panel {k}")
                del c

        # B7 on orgqr's windows: k = 0 is (16384, 16384) (also apply_q's
        # shape, trans), k = 63 is (256, 256)
        b7 = counter_key("panel_apply", mode)
        for k, trans_list in ((0, (False, True)), (63, (False,))):
            s = k * NB
            y, t = panel_pair(a, k)
            m = n - s
            groups = pa.card_project_plan(y, a[s:, s:], pa._block(m, NB, 1024), mode,
                                          fold=True).groups
            for trans in trans_list:
                outs = []
                for fn, prec in ((pa.panel_apply, mode), (pa.panel_apply_plain, mode),
                                 (pa.panel_apply_plain, "highest")):
                    win = a.clone()[s:, s:]  # a strided window, as orgqr's
                    kw = {} if fn is pa.panel_apply else {"groups": groups}
                    fn(y, t, win, trans=trans, precision=prec, **kw)
                    outs.append(win)
                compare_mode(rec, "panel_apply", mode,
                             f"window k={k} ({m}, {m}) trans={trans} G={groups}", *outs)
                del outs, win
            c = a.clone()[s:, s:]
            if k == 0:
                # B7's library call ("highest"): ormqr with tau = diag(T)
                # applies the same Q, as for B6 in phase 4
                lib = None
                if mode == "highest":
                    tau, win_c = torch.diagonal(t).contiguous(), c.contiguous()
                    lib_rel = rel(torch.ormqr(y, tau, win_c, left=True, transpose=False),
                                  pa.panel_apply_plain(y, t, win_c.clone(), trans=False))
                    print(f"library panel_apply k=0: torch.ormqr(Y, diag(T)) vs plain: "
                          f"rel_fro={lib_rel:.3e}")
                    require(lib_rel <= TOL_KERNEL,
                            f"ormqr differs from panel_apply: {lib_rel:.3e}")
                    lib = lambda: torch.ormqr(y, tau, win_c, left=True, transpose=False)  # noqa: E731
                rec.bound[b7] = bound(b7, m, m)
                rec.time(b7, lambda: pa.panel_apply(y, t, c, trans=False, **pm),
                         lambda: pa.panel_apply_plain(y, t, c, trans=False, **pm), lib, 5, 2,
                         card)
                del lib
            else:
                rec.time(b7, lambda: pa.panel_apply(y, t, c, trans=False, **pm),
                         lambda: pa.panel_apply_plain(y, t, c, trans=False, **pm), None, 20, 5,
                         card, label=f"window k={k} ({m}, {m})", bound=bound(b7, m, m))
            bf16_chain_ms(chain_fn(y, t, c), card, f"{b7} window k={k}")
            del c
    torch.cuda.empty_cache()


def mode_path(a: torch.Tensor, path: str, mode: str, card: str) -> dict:
    """qr on one path in one emulated mode, with the counts set to 0 just
    before and read just after, and its gates; returns the launches."""
    import tileqr_torch
    from tileqr_torch.drivers.square_hr import apply_q_hr
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    n = a.shape[0]
    cfg = tileqr_torch.QRConfig(square_method=path, precision=mode)
    own = (("panel_factor", f"couple_strip[{mode}]", f"larfb_strip[{mode}]")
           if path == "hh" else
           ("potrf_batched", "modified_lu", f"panel_apply_carry[{mode}]", f"panel_apply[{mode}]"))
    (q, r), launches = run_counted(lambda: tileqr_torch.qr(a, config=cfg), own, {},
                                   f"{path} qr {n}x{n} precision={mode}")
    require(bool(torch.isfinite(q).all()) and bool(torch.isfinite(r).all()), "non-finite Q/R")
    tol = TOL_MODE_RELERR[mode]
    res = residuals_f64(a, q, r)
    del q
    f = tileqr_torch.qr_factor(a, cfg)
    if path == "hr":
        panels64 = [(y.double(), t.double()) for y, t in f.panels]
        relerr = backward_error_f64(a, apply_q_hr(panels64, a.double(), f.nb, trans=True), r)
        del panels64
        how = "Q^T applied in float64"
    else:
        relerr = backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r)
        how = "Q^T applied by the fp32 'highest' apply"
    print(f"{path} qr {n}x{n} precision={mode}: relerr ({how}) {relerr:.3e}, explicit-Q "
          f"residual {res['relerr']:.3e}, orth {res['orth']:.3e} [{card}]")
    require(relerr <= tol and res["relerr"] <= tol, f"{path} {mode}: relerr/residual past {tol}")
    if mode != "default":
        require(res["orth"] <= TOL_MODE_ORTH, f"{path} {mode}: orth {res['orth']:.3e}")
    if path == "hr":
        h = float(f.health)
        print(f"hr qr {n}x{n} precision={mode}: health {h:.3e}, hr_guard_tau {cfg.hr_guard_tau}")
        require(h <= cfg.hr_guard_tau, f"hr {mode} health {h:.3e}")
    f2 = tileqr_torch.qr_factor(a, cfg)
    flat = ((lambda g: [g.packed, g.r_diag, g.t_geqrt] + [x for pp in g.panels for x in pp])
            if path == "hh" else (lambda g: [g.r] + [x for pp in g.panels for x in pp]))
    same = all(torch.equal(x, y) for x, y in zip(flat(f), flat(f2)))
    print(f"{path} qr_factor precision={mode} rerun bitwise equal: {same}")
    require(same, f"{path} {mode} qr_factor reruns differ")
    del f, f2, r
    torch.cuda.empty_cache()
    return launches


def time_modes(a: torch.Tensor, path: str, card: str, reps: int) -> None:
    """qr_factor in every mode beside "highest" and cuSOLVER, in one call."""
    import tileqr_torch

    n = a.shape[0]
    flops = 2.0 * n * n * (n - n / 3.0)
    for mode in ("highest",) + EMULATED_MODES:
        cfg = tileqr_torch.QRConfig(square_method=path, precision=mode)
        tileqr_torch.qr_factor(a, cfg)
        ms = cuda_ms(lambda: tileqr_torch.qr_factor(a, cfg), reps)
        print(f"{path} qr_factor {n}x{n} precision={mode}: {ms:.3f} ms, "
              f"{flops / ms / 1e9:.3f} TFLOP/s [{card}]")
    torch.linalg.qr(a, mode="r")
    ms = cuda_ms(lambda: torch.linalg.qr(a, mode="r"), reps)
    print(f"{path} torch.linalg.qr(mode='r') {n}x{n} (cuSOLVER reference): {ms:.3f} ms, "
          f"{flops / ms / 1e9:.3f} TFLOP/s [{card}]")


def add_mode_launches(total: dict, launches: dict, mode: str) -> None:
    """Add one run's launches of the mode's instantiations to the total."""
    for k, v in launches.items():
        if k.endswith(f"[{mode}]"):
            total[k] = total.get(k, 0) + v


def phase9(rec: KernelRecord, rng, card: str) -> dict:
    """The emulated precisions; returns each mode kernel's launches in the
    qr runs."""
    from tileqr_torch.kernels import chain, panel

    launches = {}
    # K3/K4 and the hh path at 8192²
    a = torch.from_numpy(rng.standard_normal((N, N), dtype=np.float32)).cuda()
    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK
    r_k, v_stack, tg, t2h = panel.panel_factor(a, 0, NB, IB, n_head)
    _, v_chunks, t2t = chain.panel_chain(a, r_k, 0, NB, 1, n_chunks, br, IB)
    libraries = strip_libraries(a, r_k)
    for mode in EMULATED_MODES:
        strip_kernels(a, rec, card, (v_stack, tg, t2h, v_chunks, t2t), mode, libraries)
    del r_k, v_stack, tg, t2h, v_chunks, t2t, libraries
    for mode in EMULATED_MODES:
        add_mode_launches(launches, mode_path(a, "hh", mode, card), mode)
    time_modes(a, "hh", card, 1)
    del a
    torch.cuda.empty_cache()

    # B6/B7 and the hr path at 16384²
    a = torch.from_numpy(rng.standard_normal((N_HR, N_HR), dtype=np.float32)).cuda()
    for mode in ("highest",) + EMULATED_MODES:
        apply_kernels(a, rec, card, mode)
    for mode in EMULATED_MODES:
        add_mode_launches(launches, mode_path(a, "hr", mode, card), mode)
    time_modes(a, "hr", card, 2)
    del a
    torch.cuda.empty_cache()
    return launches


def sharded_kernels(a: torch.Tensor, rec: KernelRecord, card: str) -> None:
    """TTQRT, the single-tile entries, B13 and B14 at the sharded path's
    shapes, against their plain versions, with bounds and times."""
    from tileqr_torch.kernels import chain, larfb, panel, ssrfb, tsqrt, ttqrt, update

    nb = NB
    # two R tiles of the run's A, as K1 leaves them on two ranks of a column
    r1 = panel.panel_factor(a[:nb, :nb].contiguous(), 0, nb, IB, 0)[0]
    r2 = panel.panel_factor(a[nb : 2 * nb, :nb].contiguous(), 0, nb, IB, 0)[0]
    got, want, full = ttqrt.ttqrt(r1, r2), ttqrt.ttqrt_plain(r1, r2), tsqrt.tsqrt(r1, r2)
    rec.compare("ttqrt", f"two R tiles ({nb}, {nb})", got, want)
    # TTQRT runs the cluster routine on the couple's live rows, the TSQRT
    # kernel (K2) on all its rows: the same algebra with the sums in another
    # order, so the two are held to each other at the kernel tolerance
    diff = max(max_abs(g, f) for g, f in zip(got, full))
    drel = max(rel(g, f) for g, f in zip(got, full))
    print(f"kernel ttqrt against the TSQRT kernel on the same couple: rel_fro {drel:.3e}, "
          f"max abs difference {diff:.3e}")
    require(drel <= TOL_KERNEL,
            f"ttqrt differs from the TSQRT kernel by more than {TOL_KERNEL}: {drel:.3e}")
    again = ttqrt.ttqrt(r1, r2)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    print(f"kernel ttqrt two R tiles: rerun bitwise equal: {same}")
    require(same, "ttqrt reruns differ")
    couple = torch.cat([r1, r2]).contiguous()
    rec.set_bound("ttqrt", 2.0 * nb ** 3 / 3.0, 4 * 5 * nb * nb)
    rec.time("ttqrt", lambda: ttqrt.ttqrt(r1, r2), lambda: ttqrt.ttqrt_plain(r1, r2),
             lambda: torch.geqrf(couple), 20, 3, card)
    plan = ttqrt.ttqrt_plan(nb, ttqrt.TREE_IB)
    ts_ms = cuda_ms(lambda: tsqrt.tsqrt(r1, r2), 20)
    print(f"cluster ttqrt nb={nb} ib={ttqrt.TREE_IB}: C={plan.ctas} CTAs, largest block's live "
          f"rows {ttqrt.ttqrt_rows(nb, ttqrt.TREE_IB)} of the couple's {2 * nb}, "
          f"{plan.rows_per_cta} rows and {plan.smem_bytes} shared bytes per CTA, active block "
          f"resident in shared memory: {plan.resident}; time ttqrt {rec.ms['ttqrt']:.4f} ms "
          f"against the TSQRT kernel (K2, all {2 * nb} rows) {ts_ms:.4f} ms on the same couple "
          f"[{card}]")

    # tsqrt (K2, one nb-row couple) on [R1; a tile of A]
    b = a[2 * nb : 3 * nb, :nb].contiguous()
    got = tsqrt.tsqrt(r1, b)
    want = chain.panel_chain_plain(b, r1, 0, nb, 0, 1, nb, 128)
    rec.compare("panel_chain", f"tsqrt [R; B] ({2 * nb}, {nb})", got,
                [want[0], want[1][0], want[2][0]])
    rb = torch.cat([r1, b])
    rec.time("panel_chain", lambda: tsqrt.tsqrt(r1, b), lambda: chain.panel_chain_plain(
        b, r1, 0, nb, 0, 1, nb, 128), lambda: torch.geqrf(rb), 20, 3, card,
        label="tsqrt", bound=rec.bound_of(2.0 * nb ** 3, 4 * 5 * nb * nb))

    # larfb (K4) on one (nb, nb) tile with tile (0, 0)'s reflectors
    pk, tg = panel.panel_factor(a, 0, nb, IB, 0)[1:3]
    pk = pk[0]
    c1 = a[:nb, nb : 2 * nb].contiguous()
    for trans in (True, False):
        rec.compare("larfb_strip", f"larfb tile trans={trans}", [larfb.larfb(pk, tg, c1, trans)],
                    [larfb.larfb_body(pk, tg, c1, trans)])
    tile_qr = torch.geqrf(a[:nb, :nb].contiguous())
    rec.time("larfb_strip", lambda: larfb.larfb(pk, tg, c1),
             lambda: larfb.larfb_body(pk, tg, c1, True),
             lambda: torch.ormqr(tile_qr[0], tile_qr[1], c1, transpose=True), 20, 3, card,
             label="larfb", bound=rec.bound_of(3.0 * nb ** 3, 4 * 3 * nb * nb))

    # ssrfb (K3, one couple) with a TTQRT pair at the strip tree's width on
    # mesh column 0 at panel 0 (the local width less one tile column)
    _, tv2, tt2 = ttqrt.ttqrt(r1, r2)
    w = (N_SH // NB // MESH_SH[1] + 2 - 1) * nb
    top = a[:nb, :w].contiguous()
    bot = a[nb : 2 * nb, :w].contiguous()
    for trans in (True, False):
        rec.compare("ssrfb", f"strip ({nb}, {w}) trans={trans}",
                    ssrfb.ssrfb(tv2, tt2, top, bot, trans),
                    ssrfb.ssrfb_body(tv2, tt2, top, bot, trans))
    # the library call: ormqr with the couple's reflectors [I; V2] (the top
    # square zero below its diagonal) and tau = diag(T2), larft's T
    ya = torch.cat([torch.zeros((nb, nb), device=a.device), tv2])
    tau = torch.diagonal(tt2).contiguous()
    stacked = torch.cat([top, bot])
    lib = torch.ormqr(ya, tau, stacked, transpose=True)
    lib_rel = rel(lib, torch.cat(ssrfb.ssrfb_body(tv2, tt2, top, bot, True)))
    print(f"library ssrfb: torch.ormqr([0; V2], diag(T2)) vs plain: rel_fro={lib_rel:.3e}")
    require(lib_rel <= TOL_KERNEL, f"ormqr differs from ssrfb: {lib_rel:.3e}")
    # V2 (TTQRT's) and T2 upper triangular: each product nb²·w, plus the
    # three adds
    rec.set_bound("ssrfb", 3.0 * nb * nb * w + 3.0 * nb * w, 4 * (nb * nb + 4 * nb * w))
    rec.time("ssrfb", lambda: ssrfb.ssrfb(tv2, tt2, top, bot),
             lambda: ssrfb.ssrfb_body(tv2, tt2, top, bot, True),
             lambda: torch.ormqr(ya, tau, stacked, transpose=True), 10, 3, card)

    # B13: K1 on rank (0, 0)'s panel column at k = 0 (5120 rows: 16 tiles
    # and 4 dummies), GEQRT + 3 head couples into the flat buffers
    lm = (N_SH // NB // MESH_SH[0] + 4) * nb
    pcol = torch.zeros((lm, nb), device=a.device)
    pcol[: N_SH // MESH_SH[0]] = a[: N_SH // MESH_SH[0], :nb]
    n_head = CHUNK - 1
    bufs = [torch.zeros((8, nb, nb), device=a.device) for _ in range(2)]
    cpu_bufs = [torch.zeros((8, nb, nb)) for _ in range(2)]
    got = panel.panel_head(pcol, 0, n_head, bufs[0], bufs[1], 2, nb, IB)
    want = panel.panel_head(pcol.cpu(), 0, n_head, cpu_bufs[0], cpu_bufs[1], 2, nb, IB)
    rec.compare("panel_head", f"rank (0, 0) k=0 n_head={n_head}", list(got) + bufs,
                [x.to(a.device) for x in list(want) + cpu_bufs])
    head_rows = (1 + n_head) * nb
    rec.set_bound("panel_head", geqrf_flops(head_rows, nb),
                  4 * (head_rows * nb + nb * nb * (2 + 2 * (1 + n_head))))
    head_blk = pcol[:head_rows].contiguous()
    rec.time("panel_head", lambda: panel.panel_head(pcol, 0, n_head, bufs[0], bufs[1], 2, nb, IB),
             lambda: panel.panel_factor_plain(pcol, 0, nb, IB, n_head),
             lambda: torch.geqrf(head_blk), 5, 1, card)
    print_cluster("panel_head", 2 * nb, IB)

    # B14 at tileqr's static driver's shape for this mesh: rank (0, 0)'s
    # panel 0 window, 17 tile rows (16 + a dummy) × 33 tile columns
    rows, wc = (N_SH // NB // MESH_SH[0] + 1) * nb, (N_SH // NB // MESH_SH[1] + 1) * nb
    col = a[:rows, :nb].contiguous()
    _, v_stack, tgc, t2s = panel.panel_factor(col, 0, nb, IB)
    packed = v_stack.reshape(rows, nb)
    c0 = a[:rows, nb : nb + wc].contiguous()
    for trans, rev in ((True, False), (False, True)):
        outs = []
        for fn in (update.couple_apply, update.couple_apply_plain):
            c = c0.clone()
            _, strip = fn(packed, tgc, t2s, c, 0, 0, nb, trans=trans, reverse=rev)
            outs.append(torch.cat([strip, c[nb:]]))
        rec.compare("couple_strip", f"couple_apply ({rows}, {wc}) trans={trans} reverse={rev}",
                    [outs[0]], [outs[1]])
        del outs
    col_qr = torch.geqrf(col)
    n_inner = rows // nb - 1
    c = c0.clone()
    rec.time("couple_strip", lambda: update.couple_apply(packed, tgc, t2s, c, 0, 0, nb),
             lambda: update.couple_apply_plain(packed, tgc, t2s, c, 0, 0, nb),
             lambda: torch.ormqr(col_qr[0], col_qr[1], c0, transpose=True), 5, 1, card,
             label="couple_apply", bound=rec.bound_of(
                 (3.0 + 5.0 * n_inner) * nb * nb * wc,  # LARFB, then dense V2 and T2's triangle
                 4 * (rows * nb + (1 + n_inner) * nb * nb / 2 + 2 * rows * wc)))
    del c, c0, col, packed
    torch.cuda.empty_cache()


def fp32_ms(fn, card: str, what: str) -> float:
    """Time the fp32 torch call (TF32 off) that computes a kernel's function."""
    fn()
    torch.cuda.synchronize()
    ms = cuda_ms(fn, 10)
    print(f"time {what}: fp32 {ms:.4f} ms [{card}]")
    return ms


def sharded_hr_kernels(a: torch.Tensor, rec: KernelRecord, card: str) -> None:
    """B7a and B7b at rank (0, 0)'s segment-0 local shape of the hr sharded
    path on this A, in "highest" and the emulated modes, against the plain
    version of the same mode, with bounds and times beside that plain
    version and the fp32 torch call computing the same function."""
    from tileqr_torch.drivers import square_hr
    from tileqr_torch.drivers.sharded import _local_block
    from tileqr_torch.kernels import panel_apply as pa

    # C: rank (0, 0)'s 4096×8192 local matrix; Y: the reflectors of the hr
    # panel of its first tile column, (4096, 256) as the world's Y there
    c0 = _local_block(a, NB, *MESH_SH, 0, 0).contiguous()
    m, n = c0.shape
    with square_hr._highest():
        y, t, _ = square_hr.hr_panel(c0[:, :NB])
        w = (t.T @ pa.panel_project_plain(y, c0, "highest")).contiguous()
        for mode in ("highest",) + EMULATED_MODES:
            p = passes_of(mode)
            label = f"Y ({m}, {NB}), C ({m}, {n}), mr {pa._block(m, NB, 512)}"
            groups = pa.card_project_plan(y, c0, pa._block(m, NB, 512), mode, fold=False).groups
            compare_mode(rec, "panel_project", mode, f"{label}, G {groups}",
                         pa.panel_project(y, c0, mode),
                         pa.panel_project_plain(y, c0, mode, groups),
                         pa.panel_project_plain(y, c0, "highest", groups))
            outs = [fn(y, w, c0.clone(), prec) for fn, prec in (
                (pa.panel_sub, mode), (pa.panel_sub_plain, mode), (pa.panel_sub_plain, "highest"))]
            compare_mode(rec, "panel_sub", mode, label, *outs)
            del outs
            # each product 2·m·nb·n flops (p bf16 passes in an emulated
            # mode), the subtraction m·n in fp32; each input read once and
            # each output written once
            mm = 2.0 * m * NB * n
            kp, ks = counter_key("panel_project", mode), counter_key("panel_sub", mode)
            rec.bound[kp] = rec.bound_of(0.0 if p else mm, 4 * (m * NB + m * n + NB * n), p * mm)
            rec.bound[ks] = rec.bound_of(m * n + (0.0 if p else mm),
                                         4 * (m * NB + NB * n + 2 * m * n), p * mm)
            c = c0.clone()
            lib_p, lib_s = (lambda: y.T @ c0), (lambda: torch.addmm(c0, y, w, alpha=-1.0))
            hi = mode == "highest"
            rec.time(kp, lambda: pa.panel_project(y, c0, mode),
                     lambda: pa.panel_project_plain(y, c0, mode), lib_p if hi else None, 10, 3,
                     card)
            rec.time(ks, lambda: pa.panel_sub(y, w, c, mode),
                     lambda: pa.panel_sub_plain(y, w, c, mode), lib_s if hi else None, 10, 3,
                     card)
            if not hi:  # the split product has no library call: the fp32 one beside it
                fp32_ms(lib_p, card, f"{kp} beside Y^T C")
                fp32_ms(lib_s, card, f"{ks} beside torch.addmm(C, Y, W, alpha=-1)")
            del c
    del c0, y, w
    torch.cuda.empty_cache()


def sharded_rank(mesh, n: int, seed: int, cfg) -> dict:
    """Rank side of phase 10 (run on every rank of the world): the main
    path counted, the factor rerun and timed, Q formed; rank 0 checks and
    holds R against the single-card hh R."""
    import torch.distributed as dist

    import tileqr_torch
    from tileqr_torch.drivers.sharded import planned_launches
    from tileqr_torch.kernels import _build
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).to(dev)

    def factor():
        return tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")

    # the main path, counted on every rank: factor, R, Qᵀ·A
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_counts()
    mesh.reset_counts()
    f = factor()
    torch.cuda.synchronize()
    info = dict(launches_factor=dict(_build.LAUNCHES), moved=dict(mesh.moved),
                staged=mesh.staged, planned=planned_launches(f.grid, f.chunk, mesh.r))
    r = tileqr_torch.assemble_r_sharded(f, mesh)
    qta = tileqr_torch.apply_q_sharded(f, a, mesh, config=cfg)
    torch.cuda.synchronize()
    info.update(launches=dict(_build.LAUNCHES), plain=dict(_build.PLAIN_CALLS))

    # the factor again, timed on rank 0 between barriers, and bitwise
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dist.barrier()
    t0 = time.perf_counter()
    start.record()
    f2 = factor()
    end.record()
    torch.cuda.synchronize()
    info["host_s"] = time.perf_counter() - t0
    info["ms"] = start.elapsed_time(end)
    dist.barrier()
    info["same"] = all(torch.equal(x, y) for x, y in zip(f[:9], f2[:9]))
    del f2
    eye = torch.eye(n, device=dev)
    q = tileqr_torch.apply_q_sharded(f, eye, mesh, trans=False, config=cfg)
    del eye, f
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, info)
    if mesh.rank != 0:
        return None
    out = dict(ranks=ranks, relerr=backward_error_f64(a, qta, r), mesh_shape=mesh.shape)
    del qta
    torch.cuda.empty_cache()
    res = residuals_f64(a, q, r)
    out.update(resid=res["relerr"], orth=res["orth"])
    del q
    torch.cuda.empty_cache()
    out["r_vs_hh"] = sign_fixed_rel(r, tileqr_torch.qr(a, mode="r"))
    return out


def sharded_hr_rank(mesh, n: int, seed: int, modes) -> dict:
    """Rank side of phase 11 (run on every rank of the world): in each mode
    the main path counted call by call, the factor rerun and timed, Q
    formed; rank 0 checks and holds R against the single-card hr R."""
    import torch.distributed as dist

    import tileqr_torch
    from tileqr_torch.dist.launch import digest
    from tileqr_torch.drivers.sharded_hr import planned_launches_hr
    from tileqr_torch.kernels import _build
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).to(dev)

    def counted(fn):
        """fn() with the counts set to 0 just before and read just after."""
        torch.cuda.synchronize()
        dist.barrier()
        _build.reset_counts()
        mesh.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)

    def flat(f):
        return [f.local, f.r_diag, f.t_all, f.health, *f.y_segs]

    out = {}
    for mode in modes:
        cfg = tileqr_torch.QRConfig(mesh_shape=mesh.shape, square_method="hr", precision=mode)

        def factor():
            return tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")

        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a guard trip fails the run
            f, launches, plain = counted(factor)
        info = dict(kind=type(f).__name__, health=float(f.health), launches_factor=launches,
                    plain=dict(factor=plain), moved=dict(mesh.moved), staged=mesh.staged,
                    planned=planned_launches_hr(f.grid, f.nb, mode),
                    planned_apply=planned_launches_hr(f.grid, f.nb, mode, cols=n // mesh.pc))
        r, info["launches_r"], info["plain"]["r"] = counted(
            lambda: tileqr_torch.assemble_r_sharded(f, mesh))
        qta, info["launches_qta"], info["plain"]["qta"] = counted(
            lambda: tileqr_torch.apply_q_sharded(f, a, mesh, config=cfg))

        # the factor again, timed on rank 0 between barriers, and bitwise
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        start.record()
        f2 = factor()
        end.record()
        torch.cuda.synchronize()
        info.update(host_s=time.perf_counter() - t0, ms=start.elapsed_time(end),
                    same=all(torch.equal(x, y) for x, y in zip(flat(f), flat(f2))),
                    digest=digest(f.r_diag, f.t_all, f.health))
        del f2
        dist.barrier()
        eye = torch.eye(n, device=dev)
        q, info["launches_q"], info["plain"]["q"] = counted(
            lambda: tileqr_torch.apply_q_sharded(f, eye, mesh, trans=False, config=cfg))
        del eye, f
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, info)
        if mesh.rank == 0:
            res = dict(ranks=ranks, relerr=backward_error_f64(a, qta, r))
            del qta
            torch.cuda.empty_cache()
            err = residuals_f64(a, q, r)
            del q
            torch.cuda.empty_cache()
            res.update(resid=err["relerr"], orth=err["orth"], r_vs_hr=sign_fixed_rel(
                r, tileqr_torch.qr(a, mode="r", config=tileqr_torch.QRConfig(
                    square_method="hr", precision=mode))))
            out[mode] = res
        del r
        qta = q = None
        torch.cuda.empty_cache()
    return out if mesh.rank == 0 else None


def sharded_world(mesh, hh: dict, hr: dict):
    """Phases 10 and 11 in one world of ranks (one spawn): the Householder
    sharded path, then the hr one."""
    out = dict(hh=sharded_rank(mesh, **hh))
    torch.cuda.empty_cache()
    out["hr"] = sharded_hr_rank(mesh, **hr)
    return out if mesh.rank == 0 else None


def phase11(out: dict, card: str) -> dict:
    """The hr sharded path's gates on the world's results; returns its
    kernels' launches summed over the ranks' counted runs (factor, R and
    QᵀA in each mode)."""
    import tileqr_torch
    from tileqr_torch.kernels import _build

    pr, pc = MESH_SH
    k_max = N_SH // NB
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    flops = 2.0 * N_SH * N_SH * (N_SH - N_SH / 3.0)
    tau = tileqr_torch.QRConfig().hr_guard_tau
    for mode in SH_HR_MODES:
        res = out[mode]
        ranks = res["ranks"]
        own = tuple(ranks[0]["planned"])
        halves = tuple(res["ranks"][0]["planned_apply"])
        for i, d in enumerate(ranks):
            lf = d["launches_factor"]
            print(f"sharded hr {mode} rank {i} factor launches "
                  f"{json.dumps({k: lf[k] for k in own})}, planned {json.dumps(d['planned'])}")
            require(d["kind"] == "ShardedHRFactors", f"rank {i}: the hr guard fell back")
            require(all(lf[k] == d["planned"][k] for k in own), f"rank {i}: factor launches "
                    f"off the plan")
            require(not any(v for k, v in lf.items() if k not in own),
                    f"rank {i}: the factor launched other kernels")
            for what in ("qta", "q"):
                la = d[f"launches_{what}"]
                require(all(la[k] == d["planned_apply"][k] for k in halves)
                        and not any(v for k, v in la.items() if k not in halves),
                        f"rank {i}: apply_q_sharded ({what}) launches off the plan: {la}")
            require(not any(d["launches_r"].values()), f"rank {i}: assemble_r launched kernels")
            require(not any(v for p in d["plain"].values() for v in p.values()),
                    f"rank {i}: a plain version ran: {d['plain']}")
            require(d["same"], f"rank {i}: the hr factor's rerun is not bitwise equal")
            require(d["health"] <= tau, f"rank {i}: health {d['health']:.3e} past hr_guard_tau")
            for k in _build.LAUNCHES:
                launches[k] += d["launches_factor"][k] + d["launches_r"][k] + d["launches_qta"][k]
        require(len({d["digest"] for d in ranks}) == 1,
                f"{mode}: r_diag/t_all/health differ across the ranks")
        print(f"sharded hr {mode}: every rank's factor launches as planned, no plain version, "
              f"rerun bitwise equal on every rank, r_diag/t_all/health bitwise equal across the "
              f"{pr * pc} ranks; health {ranks[0]['health']:.3e} (hr_guard_tau {tau})")
        r0 = ranks[0]
        for name, nbytes in r0["moved"].items():
            print(f"sharded hr {mode} rank 0 {name}: {nbytes / k_max / 2 ** 20:.3f} MiB per panel")
        total = sum(sum(d["moved"].values()) for d in ranks)
        staged = sum(d["staged"] for d in ranks)
        print(f"sharded hr {mode} factor, all ranks: {total / k_max / 2 ** 20:.3f} MiB per panel "
              f"through the collectives, {staged / k_max / 2 ** 20:.3f} MiB per panel staged "
              f"through the host by the mesh ({staged / max(total, 1):.3f} of it; gloo stages "
              f"its own CUDA broadcasts and all_reduces too)")
        print(f"sharded hr qr_sharded factor {N_SH}x{N_SH} precision={mode} on {pr}x{pc} ranks "
              f"time-sharing ONE card (not a multi-GPU figure): {r0['ms']:.3f} ms by CUDA "
              f"events on rank 0, host {r0['host_s']:.3f} s, "
              f"{flops / r0['ms'] / 1e9:.3f} TFLOP/s [{card}]")
        print(f"sharded hr {N_SH}x{N_SH} precision={mode}: relerr ||Q^T A - R||F/||A||F = "
              f"{res['relerr']:.3e}, explicit-Q residual {res['resid']:.3e}, orth "
              f"{res['orth']:.3e}; R against the single-card hr R of the same mode (row signs "
              f"matched) rel_fro={res['r_vs_hr']:.3e} [{card}]")
        t_rel, t_res, t_orth = TOL_SH_HR[mode]
        require(res["relerr"] <= t_rel, f"sharded hr {mode} relerr {res['relerr']:.3e} > {t_rel}")
        require(res["resid"] <= t_res and res["orth"] <= t_orth,
                f"sharded hr {mode} explicit-Q residual {res['resid']:.3e} / orth "
                f"{res['orth']:.3e}")
    return launches


def phase10(rec: KernelRecord, rng, card: str):
    """The sharded paths, phases 10 and 11 in one world; returns the hh
    path's new kernels' launches summed over the ranks of its counted run,
    and the hr path's (``phase11``)."""
    import tileqr_torch
    from tileqr_torch.dist import launch
    from tileqr_torch.kernels import _build

    a = torch.from_numpy(rng.standard_normal((N_SH, N_SH), dtype=np.float32)).cuda()
    sharded_kernels(a, rec, card)
    sharded_hr_kernels(a, rec, card)
    del a
    torch.cuda.empty_cache()

    pr, pc = MESH_SH
    backend, why = launch.backend_for("cuda", pr * pc)
    print(f"sharded {pr}x{pc} world on {torch.cuda.device_count()} card(s): backend {backend} "
          f"({why}) [{card}]")
    seed = int(rng.integers(2 ** 31))
    seed_hr = int(rng.integers(2 ** 31))
    t0 = time.perf_counter()
    both = launch.run_world(sharded_world, pr, pc, device="cuda", timeout=900, kwargs=dict(
        hh=dict(n=N_SH, seed=seed, cfg=tileqr_torch.QRConfig(mesh_shape=MESH_SH)),
        hr=dict(n=N_SH, seed=seed_hr, modes=SH_HR_MODES)))
    print(f"sharded world (phases 10 and 11): {time.perf_counter() - t0:.1f} s from spawn to "
          f"rank 0's result")
    out = both["hh"]
    ranks = out["ranks"]
    k_max = N_SH // NB
    own = ("panel_chain", "couple_strip", "larfb_strip", "ttqrt", "panel_head", "ssrfb")
    for i, d in enumerate(ranks):
        lf = d["launches_factor"]
        print(f"sharded rank {i} factor launches {json.dumps({k: lf[k] for k in own})}, "
              f"planned {json.dumps(d['planned'])}")
        require(all(lf[k] == d["planned"][k] for k in own), f"rank {i}: launches off the plan")
        require(not any(v for k, v in lf.items() if k not in own),
                f"rank {i}: the factor launched other kernels")
        require(not any(d["plain"].values()), f"rank {i}: a plain version ran: {d['plain']}")
        require(d["same"], f"rank {i}: the factor's rerun is not bitwise equal")
    launches = {k: sum(d["launches"][k] for d in ranks) for k in _build.LAUNCHES}
    require(all(launches[k] >= 1 for k in ("panel_chain", "couple_strip", "ttqrt",
                                            "panel_head", "ssrfb")),
            f"a kernel of the sharded path never launched: {launches}")
    print(f"sharded path launches over the {pr * pc} ranks (factor + assemble_r + QᵀA): "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    print("sharded factor rerun bitwise equal on every rank: True")
    r0 = ranks[0]
    for name, nbytes in r0["moved"].items():
        print(f"sharded rank 0 {name}: {nbytes / k_max / 2 ** 20:.3f} MiB per panel")
    total = sum(sum(d["moved"].values()) for d in ranks)
    staged = sum(d["staged"] for d in ranks)
    print(f"sharded factor, all ranks: {total / k_max / 2 ** 20:.3f} MiB per panel through the "
          f"collectives, {staged / k_max / 2 ** 20:.3f} MiB per panel staged through the host by "
          f"the mesh ({staged / max(total, 1):.3f} of it; gloo stages its own CUDA broadcasts too)")
    flops = 2.0 * N_SH * N_SH * (N_SH - N_SH / 3.0)
    print(f"sharded qr_sharded factor {N_SH}x{N_SH} on {pr}x{pc} ranks time-sharing ONE card "
          f"(not a multi-GPU figure): {r0['ms']:.3f} ms by CUDA events on rank 0, host "
          f"{r0['host_s']:.3f} s, {flops / r0['ms'] / 1e9:.3f} TFLOP/s [{card}]")
    print(f"sharded {N_SH}x{N_SH}: relerr ||Q^T A - R||F/||A||F = {out['relerr']:.3e}, "
          f"explicit-Q residual {out['resid']:.3e}, orth {out['orth']:.3e}; R against the "
          f"single-card hh R (row signs matched) rel_fro={out['r_vs_hh']:.3e} [{card}]")
    require(out["relerr"] <= TOL_RELERR, f"sharded relerr {out['relerr']:.3e} > {TOL_RELERR}")
    require(out["resid"] <= TOL_SH_RESID and out["orth"] <= TOL_ORTH,
            f"sharded explicit-Q residual {out['resid']:.3e} / orth {out['orth']:.3e}")
    return launches, phase11(both["hr"], card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    import tileqr_torch
    from tileqr_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    rng = np.random.default_rng(0)
    rec = KernelRecord()

    # the hh path at 8192²
    hh = tileqr_torch.QRConfig()
    a = torch.from_numpy(rng.standard_normal((N, N), dtype=np.float32)).cuda()
    phase1(a, rec, card)
    launches, q, r = run_path(a, hh, "hh", card)
    check_path(a, q, r, hh, rng, "hh", card)
    del q, r
    time_path(a, hh, "hh", card, 2)
    del a
    torch.cuda.empty_cache()

    # the hr path at 16384²
    hr = tileqr_torch.QRConfig(square_method="hr")
    a = torch.from_numpy(rng.standard_normal((N_HR, N_HR), dtype=np.float32)).cuda()
    phase4(a, rec, card)
    hr_launches, q, r = run_path(a, hr, "hr", card)
    check_path(a, q, r, hr, rng, "hr", card)
    del q, r
    torch.cuda.empty_cache()
    time_path(a, hr, "hr", card, 2)

    launches.update({k: hr_launches[k] for k in _build.HR_KERNELS + _build.APPLY_KERNELS})
    del a
    torch.cuda.empty_cache()

    # the tall-skinny and batched paths at BASELINE configs 3 and 4
    ts, ts_b7 = phase7(rec, rng, card)
    ba = phase8(rec, rng, card)
    print(f"geqrt_batched launches: {ts} in tsqr r, {ba} in qr_batched")
    launches.update(ts)
    launches["geqrt_batched[small]"] += ba

    # the emulated precisions on both square paths
    launches.update(phase9(rec, rng, card))
    launches[counter_key("panel_apply", "b3")] += ts_b7

    # the sharded paths: their new kernels' launches over the world's ranks
    sh, sh_hr = phase10(rec, rng, card)
    launches.update({k: sh[k] for k in _build.SHARDED_KERNELS + _build.SITE_KERNELS})
    # K2 launches alone on the sharded path: the hh driver runs its panels'
    # K2 couples inside K1's pipelined launch
    launches["panel_chain"] += sh["panel_chain"]
    launches.update({k: sh_hr[k] for k in KERNEL_INFO if k.split("[")[0] in SHARDED_HR_KERNELS})
    # the one-block kernel keeps only stacks that no path runs (one_block)
    idle = [k for k in KERNEL_INFO if not launches[k] and k != "geqrt_batched"]
    require(not idle, f"kernels of the line that no path launched: {idle}")
    print(json.dumps({"kernels": rec.line(launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

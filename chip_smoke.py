#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's square, tall-skinny and batched paths on
one GPU and check them.

    python3 chip_smoke.py            # from the repository root

Builds the CUDA kernels from ``tileqr_torch/csrc`` into ``build/`` on first
use (one nvcc per source, in parallel), then:

1. holds each hh kernel K1-K4 against its plain torch version on the card,
   in fp32, at the hh path's shapes (nb=256, ib=128, head couples of nb
   rows, chunk couples of 4·nb rows, a strip of 7936 columns = 248 column
   slabs), and times kernel, plain version and the PyTorch call that
   computes the same function (``torch.geqrf`` / ``torch.ormqr``);
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
   so it applies the same Qᵀ); B6's three-matmul chain is timed beside it;
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
   ``QRConfig(nb=512)``: holds the batched GEQRT kernel against its plain
   version on the 512 leaves of 2048 rows and on the first tree level's
   (128, 2048, 512) stack, and times it beside its plain version and
   ``torch.geqrf`` on the leaf stack; runs ``tsqr(a, "r")`` (auto → tree)
   with the counts set to 0 just before and read just after (6 launches of
   the kernel: the leaves and 5 levels; no other kernel, no plain version)
   and ``tsqr(a, "reduced")``, and checks the relerr ‖QᵀA − [R; 0]‖F/‖A‖F
   through ``apply_q`` on the tree's ``TSQRFactors`` ≤ 1e-6, the explicit-Q
   residual ≤ 3e-6, ‖QᵀQ − I‖F ≤ 1e-3, R against ``torch.linalg.qr`` up to
   row signs (printed), bitwise reruns; then ``tsqr(a, "factor")`` (auto →
   cholqr2 → ``HRFactors``): health ≤ hr_guard_tau with no guard warning,
   B9 and B8 launched at n = 512, the relerr with Qᵀ applied in float64
   ≤ 1e-6, and the fp32 ``apply_q`` relerr printed (held to 3e-6 when above
   1e-6, as for hr); ``apply_q`` in "b3" of those factors to A, with the
   counts set to 0 just before and read just after (nb = 512: one launch
   of B7's split instantiation, no plain version; relerr ≤ 1e-4), and B7
   at that shape against its b3 and "highest" plain versions, timed; times
   ``tsqr`` r (tree), factor (cholqr2), factor + ``apply_q`` on 16 columns
   and ``torch.linalg.qr(mode="r")``;
8. the batched path at BASELINE config 4, a (4096, 128, 128) gaussian
   stack with the default QRConfig: holds the kernel against its plain
   version at ib = 32 (``qr_batched``'s width) and ib = 128, and ``geqrt``
   on one 256² tile (the global-workspace variant), each timed beside
   ``torch.geqrf``; runs ``qr_batched(a)`` with the counts set to 0 just
   before and read just after (one kernel launch, no plain version) and
   checks the max over the batch of ‖A − QR‖F/‖A‖F ≤ 1e-6 and of
   ‖QᵀQ − I‖F ≤ 1e-3 and bitwise reruns; with
   ``batched_method="cholqr2"`` the guard must trip on the gaussian stack
   (its ill-conditioned tail) and the fallback meet the same gates, and on
   a well-conditioned stack (G + 4·√128·I) must not trip: health ≤ tau,
   one B9 launch, no GEQRT launch, the same gates; times both methods
   beside ``torch.linalg.qr`` on the stack;
9. the emulated precisions "b3", "b4" and "default" (bf16 split products
   on the tensor cores, ``csrc/bx_mma.cuh``): K3 and K4 at phase 1's
   shapes, B6 on panels 0 and 48 of a 16384² A and B7 (also in "highest")
   on ``orgqr``'s k = 0 (16384², both trans) and k = 63 (256²) windows,
   each held against the plain version of its own mode within
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
   (B15) on two R tiles of that A against its plain version and against
   the TSQRT kernel (equal up to the sign of zero), the single-tile entries
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
   panel through each collective with the host-staged share.

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

from tileqr_torch.kernels._build import EMULATED_MODES, MODE_KERNELS
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

# B15's single-tile tsqrt and larfb and B14's couple_apply are K2, K4 and K3
# at one shape that no path runs (tileqr's unit-test entries; B14 is the
# static driver's sweep, which the port's driver runs as K3 at chunk 1):
# they stand in those kernels' rows, checked and timed as labelled shapes
KERNEL_INFO = {
    "panel_factor": ("tileqr_torch/csrc/panel.cu", "tileqr/kernels/panel.py:90"),
    "panel_chain": ("tileqr_torch/csrc/chain.cu",
                    "tileqr/kernels/chain.py:83, tileqr/kernels/tsqrt.py:46"),
    "couple_strip": ("tileqr_torch/csrc/chain.cu",
                     "tileqr/kernels/chain.py:212, tileqr/kernels/update.py:115"),
    "larfb_strip": ("tileqr_torch/csrc/chain.cu",
                    "tileqr/kernels/chain.py:267, tileqr/kernels/larfb.py:44"),
    "modified_lu": ("tileqr_torch/csrc/modlu.cu", "tileqr/kernels/modlu.py:93"),
    "potrf_batched": ("tileqr_torch/csrc/potrf.cu", "tileqr/drivers/cholqr.py:203"),
    "panel_apply_carry": ("tileqr_torch/csrc/panel_apply.cu",
                          "tileqr/kernels/panel_apply.py:227"),
    "geqrt_batched": ("tileqr_torch/csrc/geqrt_batched.cu",
                      "tileqr/drivers/tsqr.py:217, tileqr/drivers/batched.py:167, "
                      "tileqr/drivers/batched.py:41, tileqr/kernels/geqrt.py:225"),
    "panel_apply": ("tileqr_torch/csrc/panel_apply.cu", "tileqr/kernels/panel_apply.py:112"),
    "ttqrt": ("tileqr_torch/csrc/ttqrt.cu", "tileqr/kernels/ttqrt.py:68"),
    # TPU kernels that the sharded path runs as K1/K3 with counters of their own
    "panel_head": ("tileqr_torch/csrc/panel.cu", "tileqr/drivers/sharded_dyn.py:172"),
    "ssrfb": ("tileqr_torch/csrc/chain.cu", "tileqr/kernels/ssrfb.py:44"),
}
# the split-product instantiations (the in-kernel _dot_bx of tileqr/kernels/common.py:95)
KERNEL_INFO.update({
    f"{k}[{m}]": (f"{KERNEL_INFO[k][0]} + tileqr_torch/csrc/bx_mma.cuh", KERNEL_INFO[k][1])
    for k in MODE_KERNELS for m in EMULATED_MODES
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
    """LAPACK's count for a Householder QR of an (m, n) block, m >= n."""
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0


class KernelRecord:
    def __init__(self):
        self.err = {k: 0.0 for k in KERNEL_INFO}
        self.ms, self.plain_ms, self.library_ms, self.bound = {}, {}, {}, {}

    def compare(self, name: str, label: str, got, want, tol: float = TOL_KERNEL) -> None:
        for i, (g, w) in enumerate(zip(got, want)):
            r = rel(g, w)
            self.err[name] = max(self.err[name], max_abs(g, w))
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
    """Each hh kernel against its plain version at the hh path's shapes."""
    from tileqr_torch.kernels import chain, panel

    mt = a.shape[0] // NB
    n_head, br = CHUNK - 1, CHUNK * NB
    n_chunks = (mt - 1 - n_head) // CHUNK

    # K1: GEQRT of tile (0, 0) + the 3 head couples of panel 0
    got = panel.panel_factor(a, 0, NB, IB, n_head)
    want = panel.panel_factor_plain(a, 0, NB, IB, n_head)
    rec.compare("panel_factor", "k=0 n_head=3", got, want)
    r_k, v_stack, tg, t2h = want

    # K2: the 7 chunk couples of 4·nb rows below the head
    got = chain.panel_chain(a, r_k, 0, NB, 1, n_chunks, br, IB)
    want = chain.panel_chain_plain(a, r_k, 0, NB, 1, n_chunks, br, IB)
    rec.compare("panel_chain", f"n_chunks={n_chunks} rows={br}", got, want)
    _, v_chunks, t2t = want

    # bounds at these shapes (fp32, 4 bytes an element)
    head_rows = (1 + n_head) * NB
    rec.set_bound("panel_factor", geqrf_flops(head_rows, NB),
                  4 * (head_rows * NB + NB * NB * (2 + 2 * (1 + n_head))))
    chain_rows = NB + n_chunks * br
    rec.set_bound("panel_chain", geqrf_flops(chain_rows, NB),
                  4 * (2 * n_chunks * br * NB + 2 * NB * NB + n_chunks * NB * NB))

    # the PyTorch calls that compute the same functions (yardsticks, never
    # called by the port): geqrf of the panel blocks, ormqr of their
    # reflectors on the same strip
    head_blk = a[:head_rows, :NB].contiguous()
    chain_blk = torch.cat([r_k, a[br : br * (1 + n_chunks), :NB]]).contiguous()
    chain_qr = torch.geqrf(chain_blk)
    tile_qr = torch.geqrf(a[:NB, :NB].contiguous())
    c_all = torch.cat([a[:NB, NB:], a[br : br * (1 + n_chunks), NB:]]).contiguous()
    strip_c = a[:NB, NB:].contiguous()
    strip_kernels(a, rec, card, (v_stack, tg, t2h, v_chunks, t2t), "highest", (
        lambda: torch.ormqr(chain_qr[0], chain_qr[1], c_all, left=True, transpose=True),
        lambda: torch.ormqr(tile_qr[0], tile_qr[1], strip_c, left=True, transpose=True)))

    # times at the same shapes
    rec.time("panel_factor", lambda: panel.panel_factor(a, 0, NB, IB, n_head),
             lambda: panel.panel_factor_plain(a, 0, NB, IB, n_head),
             lambda: torch.geqrf(head_blk), 5, 1, card)
    rec.time("panel_chain", lambda: chain.panel_chain(a, r_k, 0, NB, 1, n_chunks, br, IB),
             lambda: chain.panel_chain_plain(a, r_k, 0, NB, 1, n_chunks, br, IB),
             lambda: torch.geqrf(chain_blk), 5, 1, card)


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
                  libraries=None) -> None:
    """K3 and K4 in one precision mode at the hh path's shapes, against the
    plain version of the same mode: bounds and times beside that plain
    version and the library calls (``libraries``, "highest" only) or, in an
    emulated mode, three bf16 matmuls of the same shapes."""
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

    c = a.clone()
    strip = c[:NB, NB:]
    sargs = (v_chunks, t2t, c, strip, 0, 1, n_chunks, br, NB, 1)
    lib3, lib4 = libraries if libraries else (None, None)
    rec.time(k3, lambda: chain.couple_strip(*sargs, trans=True, **pm),
             lambda: chain.couple_strip_plain(*sargs, trans=True, **pm), lib3, 10, 3, card)
    rec.time(k4, lambda: chain.larfb_strip(v_stack[0], tg, strip, NB, **pm),
             lambda: chain.larfb_strip_plain(v_stack[0], tg, strip, NB, **pm), lib4, 10, 3,
             card)
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


def run_path(a: torch.Tensor, cfg, path: str, card: str):
    """``qr`` on one path with the counts set to 0 just before it and read
    just after; checks the launches of both kernel families."""
    import tileqr_torch
    from tileqr_torch.kernels import _build

    own = _build.HH_KERNELS if path == "hh" else _build.HR_KERNELS + _build.APPLY_KERNELS
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a guard trip fails the run
        _build.reset_counts()
        q, r = tileqr_torch.qr(a, config=cfg)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        plain = dict(_build.PLAIN_CALLS)
    print(f"{path} path launches {json.dumps(launches)} plain_calls {json.dumps(plain)}")
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
    ms = cuda_ms(lambda: tileqr_torch.qr_factor(a, cfg), reps)
    print(f"{path} qr_factor {n}x{n}: {ms:.3f} ms, {flops / ms / 1e9:.3f} TFLOP/s [{card}]")
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

    rec.compare("potrf_batched", "panel 0 gram (1, 256, 256)",
                [potrf.potrf_batched(g)], [potrf.potrf_batched_plain(g)])
    got, want = modlu.modified_lu(q_top), modlu.modified_lu_plain(q_top)
    require(torch.equal(got[1], want[1]), "modified_lu signs differ from the plain version")
    rec.compare("modified_lu", "panel 0 Q_top (256, 256)", [got[0]], [want[0]])
    # B8's library call: LU without pivoting of Q_top − diag(d), d taken
    # from the modified LU (the one choice the library cannot make)
    shifted = q_top - torch.diag(want[1])
    lib_rel = rel(torch.linalg.lu_factor(shifted, pivot=False)[0], want[0])
    print(f"library modified_lu: lu_factor(Q_top - diag(d), pivot=False) vs plain: "
          f"rel_fro={lib_rel:.3e}")
    require(lib_rel <= TOL_KERNEL, f"lu_factor(pivot=False) differs: {lib_rel:.3e}")

    n = a.shape[0]
    rec.set_bound("potrf_batched", NB ** 3 / 3.0, 4 * 2 * NB * NB)
    rec.set_bound("modified_lu", 2.0 * NB ** 3 / 3.0, 4 * (2 * NB * NB + NB))
    for k in HR_PANELS_TIMED:
        s = k * NB
        with square_hr._highest():
            y, t, _ = square_hr.hr_panel(a[s:, s : s + NB])
        m, w = n - s, n - s - NB
        outs = []
        for fn in (panel_apply.panel_apply_carry, panel_apply.panel_apply_carry_plain):
            c = a.clone()
            with square_hr._highest():
                fn(y, t, c, k, NB, trans=True)
            outs.append(c)
        require(torch.equal(outs[0][:s], a[:s]) and torch.equal(outs[0][:, : s + NB], a[:, : s + NB]),
                "panel_apply_carry wrote outside its window")
        rec.compare("panel_apply_carry", f"panel {k} window ({m}, {w})",
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
        del c, win, win_c

    with square_hr._highest():
        rec.time("potrf_batched", lambda: potrf.potrf_batched(g),
                 lambda: potrf.potrf_batched_plain(g),
                 lambda: torch.linalg.cholesky(g, upper=True), 20, 2, card)
        rec.time("modified_lu", lambda: modlu.modified_lu(q_top),
                 lambda: modlu.modified_lu_plain(q_top),
                 lambda: torch.linalg.lu_factor(shifted, pivot=False), 20, 2, card)


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
    with _highest():
        outs = []
        for fn, prec in ((pa.panel_apply, "b3"), (pa.panel_apply_plain, "b3"),
                         (pa.panel_apply_plain, "highest")):
            outs.append(fn(y, t, a.clone(), trans=True, precision=prec))
        compare_mode(rec, "panel_apply", "b3", f"tsqr factor ({m}, {n}) nb={nb}", *outs)
        del outs
        c = a.clone()
        bound = rec.bound_of(2.0 * nb * nb * n, 4 * (m * nb + nb * nb + 2 * m * n),
                             3 * 4.0 * m * nb * n)
        rec.time(b7, lambda: pa.panel_apply(y, t, c, precision="b3"),
                 lambda: pa.panel_apply_plain(y, t, c, precision="b3"), None, 3, 1, card,
                 label=f"tsqr factor ({m}, {n}) nb={nb}", bound=bound)
        del c
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

    # the kernel on the leaves, and on the first level's stack as
    # tsqr_factor forms it from the leaves' R factors
    got = geqrt.geqrt_batched(leaves, IB)
    want = geqrt.geqrt_batched_plain(leaves, IB)
    rec.compare("geqrt_batched", f"tsqr leaves ({p}, {lr}, {n}) ib={IB}", got, want)
    del want
    a_l = dtsqr._tree_plan(p, n, lr, 8)[0][1]
    stack = torch.triu(got[0].view(p, lr, n)[:, :n]).reshape(p // a_l, a_l * n, n)
    del got
    rec.compare("geqrt_batched", f"tsqr level 1 {tuple(stack.shape)} ib={IB}",
                geqrt.geqrt_batched(stack, IB), geqrt.geqrt_batched_plain(stack, IB))
    del stack
    torch.cuda.empty_cache()
    rec.bound["geqrt_batched"] = geqrt_bound(p, lr, n)
    rec.time("geqrt_batched", lambda: geqrt.geqrt_batched(leaves, IB),
             lambda: geqrt.geqrt_batched_plain(leaves, IB), lambda: torch.geqrf(leaves),
             2, 1, card)
    torch.cuda.empty_cache()

    # the path: tsqr r (auto → tree)
    r, launches = run_counted(lambda: tileqr_torch.tsqr(a, "r", cfg), ("geqrt_batched",),
                              {"geqrt_batched": 1 + len(dtsqr._tree_plan(p, n, lr, 8))},
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
    return launches["geqrt_batched"], b7_launches


def batched_gates(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor, what: str, card: str):
    a64, q64, r64 = a.double(), q.double(), r.double()
    res = torch.linalg.norm(a64 - q64 @ r64, dim=(1, 2)) / torch.linalg.norm(a64, dim=(1, 2))
    eye = torch.eye(q.shape[2], dtype=torch.float64, device=q.device)
    orth = torch.linalg.norm(q64.transpose(1, 2) @ q64 - eye, dim=(1, 2))
    res, orth = float(res.max()), float(orth.max())
    print(f"{what}: max residual ||A-QR||F/||A||F {res:.3e}, max orth {orth:.3e} [{card}]")
    require(res <= TOL_RELERR and orth <= TOL_ORTH, f"{what}: residual {res:.3e} orth {orth:.3e}")


def phase8(rec: KernelRecord, rng, card: str) -> int:
    """The batched path at config 4; returns the kernel's launches in its
    ``qr_batched`` run."""
    import tileqr_torch
    from tileqr_torch.drivers import cholqr
    from tileqr_torch.kernels import geqrt

    b, n = B_BA, N_BA
    hh = tileqr_torch.QRConfig()
    a = torch.from_numpy(rng.standard_normal((b, n, n), dtype=np.float32)).cuda()
    for ib in (hh.batched_ib, IB):
        rec.compare("geqrt_batched", f"batch ({b}, {n}, {n}) ib={ib}",
                    geqrt.geqrt_batched(a, ib), geqrt.geqrt_batched_plain(a, ib))
        rec.time("geqrt_batched", lambda: geqrt.geqrt_batched(a, ib),
                 lambda: geqrt.geqrt_batched_plain(a, ib), lambda: torch.geqrf(a),
                 5, 1, card, label=f"batch ({b}, {n}, {n}) ib={ib}", bound=geqrt_bound(b, n, n))
    tile = torch.from_numpy(rng.standard_normal((2 * n, 2 * n), dtype=np.float32)).cuda()
    rec.compare("geqrt_batched", "geqrt one (256, 256) tile ib=128",
                geqrt.geqrt(tile), [x[0] for x in geqrt.geqrt_batched_plain(tile[None], IB)])
    rec.time("geqrt_batched", lambda: geqrt.geqrt(tile),
             lambda: geqrt.geqrt_batched_plain(tile[None], IB), lambda: torch.geqrf(tile),
             10, 2, card, label="geqrt one (256, 256) tile ib=128",
             bound=geqrt_bound(1, 2 * n, 2 * n))

    (q, r), launches = run_counted(lambda: tileqr_torch.qr_batched(a, config=hh),
                                   ("geqrt_batched",), {"geqrt_batched": 1},
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
    return launches["geqrt_batched"]


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
                outs = []
                for fn, prec in ((pa.panel_apply_carry, mode), (pa.panel_apply_carry_plain, mode),
                                 (pa.panel_apply_carry_plain, "highest")):
                    c = a.clone()
                    fn(y, t, c, k, NB, trans=True, precision=prec)
                    outs.append(c[s:, s + NB :])
                compare_mode(rec, "panel_apply_carry", mode, f"panel {k} window ({m}, {w})",
                             *outs)
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
                del c

        # B7 on orgqr's windows: k = 0 is (16384, 16384) (also apply_q's
        # shape, trans), k = 63 is (256, 256)
        b7 = counter_key("panel_apply", mode)
        for k, trans_list in ((0, (False, True)), (63, (False,))):
            s = k * NB
            y, t = panel_pair(a, k)
            m = n - s
            for trans in trans_list:
                outs = []
                for fn, prec in ((pa.panel_apply, mode), (pa.panel_apply_plain, mode),
                                 (pa.panel_apply_plain, "highest")):
                    win = a.clone()[s:, s:]  # a strided window, as orgqr's
                    fn(y, t, win, trans=trans, precision=prec)
                    outs.append(win)
                compare_mode(rec, "panel_apply", mode,
                             f"window k={k} ({m}, {m}) trans={trans}", *outs)
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
    own = (("panel_factor", "panel_chain", f"couple_strip[{mode}]", f"larfb_strip[{mode}]")
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
    for mode in EMULATED_MODES:
        strip_kernels(a, rec, card, (v_stack, tg, t2h, v_chunks, t2t), mode)
    del r_k, v_stack, tg, t2h, v_chunks, t2t
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
    diff = max(max_abs(g, f) for g, f in zip(got, full))
    same = all(torch.equal(g, f) for g, f in zip(got, full))
    print(f"kernel ttqrt against the TSQRT kernel on the same couple: bitwise equal {same}, "
          f"max abs difference {diff:.3e}")
    require(same or max(rel(g, f) for g, f in zip(got, full)) <= 1e-6,
            "ttqrt differs from the TSQRT kernel by more than 1e-6")
    couple = torch.cat([r1, r2]).contiguous()
    rec.set_bound("ttqrt", 2.0 * nb ** 3 / 3.0, 4 * 5 * nb * nb)
    rec.time("ttqrt", lambda: ttqrt.ttqrt(r1, r2), lambda: ttqrt.ttqrt_plain(r1, r2),
             lambda: torch.geqrf(couple), 20, 3, card)

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


def phase10(rec: KernelRecord, rng, card: str) -> dict:
    """The sharded path; returns the new kernels' launches summed over the
    ranks of its counted run."""
    import tileqr_torch
    from tileqr_torch.dist import launch
    from tileqr_torch.kernels import _build

    a = torch.from_numpy(rng.standard_normal((N_SH, N_SH), dtype=np.float32)).cuda()
    sharded_kernels(a, rec, card)
    del a
    torch.cuda.empty_cache()

    pr, pc = MESH_SH
    backend, why = launch.backend_for("cuda", pr * pc)
    print(f"sharded {pr}x{pc} world on {torch.cuda.device_count()} card(s): backend {backend} "
          f"({why}) [{card}]")
    seed = int(rng.integers(2 ** 31))
    t0 = time.perf_counter()
    out = launch.run_world(sharded_rank, pr, pc, device="cuda", timeout=900, kwargs=dict(
        n=N_SH, seed=seed, cfg=tileqr_torch.QRConfig(mesh_shape=MESH_SH)))
    print(f"sharded world: {time.perf_counter() - t0:.1f} s from spawn to rank 0's result")
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
    return launches


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
    launches["geqrt_batched"] = ts + ba

    # the emulated precisions on both square paths
    launches.update(phase9(rec, rng, card))
    launches[counter_key("panel_apply", "b3")] += ts_b7

    # the sharded path: its new kernels' launches over the world's ranks
    sh = phase10(rec, rng, card)
    launches.update({k: sh[k] for k in _build.SHARDED_KERNELS + _build.SITE_KERNELS})
    idle = [k for k in KERNEL_INFO if not launches[k]]
    require(not idle, f"kernels of the line that no path launched: {idle}")
    print(json.dumps({"kernels": rec.line(launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

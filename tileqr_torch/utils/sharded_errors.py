"""The sharded path's errors on several mesh shapes, beside one device's.

    python -m tileqr_torch.utils.sharded_errors --n 16384 --meshes 1x1,2x1,4x2 --single
    python -m tileqr_torch.utils.sharded_errors --device cpu --n 1024 --nb 64 \\
        --meshes 1x1,2x1,4x2
    python -m tileqr_torch.utils.sharded_errors --method hr --n 16384 --meshes 4x2

On a gaussian fp32 (n, n) A made from ``--seed``, each mesh's world of
ranks (``dist/launch.py``; a (1, 1) mesh runs in this process) runs
``qr_sharded(mode="factor")`` at tile ``--nb``, ``assemble_r_sharded``,
``apply_q_sharded(f, A)`` and Q = ``apply_q_sharded(f, I, trans=False)``,
and prints relerr ‖QᵀA − R‖F/‖A‖F, the explicit-Q residual ‖A − QR‖F/‖A‖F
and ‖QᵀQ − I‖F, every norm in float64. ``--single`` adds the single-device
hh ``qr``'s and ``torch.linalg.qr``'s (cuSOLVER on the card) on the same A.
``--method hr`` runs the CholeskyQR2 sharded driver (square_method="hr")
and adds two more relerrs: with Qᵀ applied through its factors in float64
(the factorization's own error) and with Qᵀ applied in fp32 by B7's fp32
halves (Kahan-summed W) on the slices wider than 1024 columns in place
of tileqr's "highest" routes (split-K W on slices of ≥ 4096 rows, one
product otherwise), which the port runs: the measurement behind the
port's route.
On the card every rank of a world shares the machine's cards; the card's
name and power limit head the output.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch


def gaussian(n: int, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).to(device)


def hr_qt(f, a: torch.Tensor, mesh, dtype, halves: bool) -> torch.Tensor:
    """Qᵀ·A through the hr sharded factors in "highest", in ``dtype`` (the
    factors cast to it): the apply's panel loop, with B7's fp32 halves on
    the slices wider than 1024 columns when ``halves``."""
    from tileqr_torch.drivers import sharded, sharded_hr
    from tileqr_torch.drivers.cholqr import _highest

    nb = f.nb
    _, _, pr, pc = f.grid
    cm = sharded._local_block(a, nb, pr, pc, mesh.r, mesh.c).contiguous().to(dtype, copy=True)
    with _highest():
        for si, (ks, ke, lr, _) in enumerate(f.segs):
            sub = cm[lr * nb :]
            wide = halves and sub.shape[1] > sharded_hr._W_PAIR_MAX_COLS
            apply = sharded_hr._apply_panel_halves if wide else sharded_hr._apply_panel_torch
            for k in range(ks, ke):
                apply(f.y_segs[si][k - ks].to(dtype), f.t_all[k].to(dtype), sub, mesh,
                      "highest", True)
    return sharded._unpack(mesh, cm, nb)


def errors_rank(mesh, n: int, nb: int, seed: int, device: str, driver: str = "auto",
                method: str = "hh"):
    """One mesh's factor, R, QᵀA and Q on every rank; rank 0's errors.
    driver: ``QRConfig.driver``, which picks the chunk as tileqr does;
    method: ``QRConfig.square_method``."""
    import tileqr_torch
    from tileqr_torch.dist.mesh import rank_device
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(device)
    a = gaussian(n, seed, dev)
    cfg = tileqr_torch.QRConfig(nb=nb, ib=min(128, nb), mesh_shape=mesh.shape, driver=driver,
                                square_method=method)
    f = tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")
    r = tileqr_torch.assemble_r_sharded(f, mesh)
    extra = {}
    if isinstance(f, tileqr_torch.ShardedHRFactors):
        for name, dtype, halves in (("relerr_f64_apply", torch.float64, False),
                                    ("relerr_halves", torch.float32, True)):
            qt = hr_qt(f, a, mesh, dtype, halves)
            extra[name] = backward_error_f64(a, qt, r) if mesh.rank == 0 else None
            del qt
    qta = tileqr_torch.apply_q_sharded(f, a, mesh, config=cfg)
    q = tileqr_torch.apply_q_sharded(f, torch.eye(n, device=dev), mesh, trans=False,
                                     config=cfg)
    if mesh.rank != 0:
        return None
    # the float64 checks on rank 0 only: each takes 4-6 copies of A's size,
    # which 8 ranks on one card could not hold at once
    chunk = getattr(f, "chunk", None)
    del f
    torch.cuda.empty_cache()
    relerr = backward_error_f64(a, qta, r)
    del qta
    res = residuals_f64(a, q, r)
    return dict(chunk=chunk, relerr=relerr, resid=res["relerr"], orth=res["orth"], **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=256)
    ap.add_argument("--meshes", default="1x1,2x1,4x2", help="comma-separated PRxPC")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--single", action="store_true",
                    help="also the single-device hh qr and torch.linalg.qr")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", choices=("hh", "hr"), default="hh",
                    help="QRConfig.square_method of the sharded driver")
    args = ap.parse_args(argv)

    import tileqr_torch
    from tileqr_torch.dist import launch
    from tileqr_torch.dist.mesh import Mesh
    from tileqr_torch.utils.verify import residuals_f64

    where = "CPU"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("sharded_errors --device cuda needs a CUDA device")
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"card: {where}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(n=args.n, nb=args.nb, seed=args.seed, device=args.device, method=args.method)
    for spec in args.meshes.split(","):
        pr, pc = (int(x) for x in spec.split("x"))
        if pr * pc == 1:
            out = errors_rank(Mesh(1, 1), **kw)
            torch.cuda.empty_cache()
        else:
            out = launch.run_world(errors_rank, pr, pc, device=args.device, timeout=1800,
                                   kwargs=kw)
        what = f"chunk={out['chunk']}" if args.method == "hh" else "hr"
        hr = "" if args.method == "hh" else (
            f"; relerr with Q^T in float64 {out['relerr_f64_apply']:.3e}, with B7's fp32 "
            f"halves on the slices wider than 1024 columns {out['relerr_halves']:.3e}")
        print(f"sharded {pr}x{pc} {args.n}x{args.n} nb={args.nb} {what}: "
              f"relerr {out['relerr']:.3e}, explicit-Q residual {out['resid']:.3e}, "
              f"orth {out['orth']:.3e}{hr} [{where}]", flush=True)
    if args.single:
        a = gaussian(args.n, args.seed, args.device)
        for name, fn in (("hh qr", lambda x: tileqr_torch.qr(
                x, config=tileqr_torch.QRConfig(nb=args.nb, ib=min(128, args.nb)))),
                         ("torch.linalg.qr", torch.linalg.qr)):
            q, r = fn(a)
            res = residuals_f64(a, q, r)
            del q, r
            print(f"single device {name} {args.n}x{args.n}: explicit-Q residual "
                  f"{res['relerr']:.3e}, orth {res['orth']:.3e} [{where}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

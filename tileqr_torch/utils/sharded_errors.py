"""The sharded path's errors on several mesh shapes, beside one device's.

    python -m tileqr_torch.utils.sharded_errors --n 16384 --meshes 1x1,2x1,4x2 --single
    python -m tileqr_torch.utils.sharded_errors --device cpu --n 1024 --nb 64 \\
        --meshes 1x1,2x1,4x2

On a gaussian fp32 (n, n) A made from ``--seed``, each mesh's world of
ranks (``dist/launch.py``; a (1, 1) mesh runs in this process) runs
``qr_sharded(mode="factor")`` at tile ``--nb``, ``assemble_r_sharded``,
``apply_q_sharded(f, A)`` and Q = ``apply_q_sharded(f, I, trans=False)``,
and prints relerr ‖QᵀA − R‖F/‖A‖F, the explicit-Q residual ‖A − QR‖F/‖A‖F
and ‖QᵀQ − I‖F, every norm in float64. ``--single`` adds the single-device
hh ``qr``'s and ``torch.linalg.qr``'s (cuSOLVER on the card) on the same A.
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


def errors_rank(mesh, n: int, nb: int, seed: int, device: str, driver: str = "auto"):
    """One mesh's factor, R, QᵀA and Q on every rank; rank 0's errors.
    driver: ``QRConfig.driver``, which picks the chunk as tileqr does."""
    import tileqr_torch
    from tileqr_torch.dist.mesh import rank_device
    from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(device)
    a = gaussian(n, seed, dev)
    cfg = tileqr_torch.QRConfig(nb=nb, ib=min(128, nb), mesh_shape=mesh.shape, driver=driver)
    f = tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")
    r = tileqr_torch.assemble_r_sharded(f, mesh)
    qta = tileqr_torch.apply_q_sharded(f, a, mesh, config=cfg)
    q = tileqr_torch.apply_q_sharded(f, torch.eye(n, device=dev), mesh, trans=False,
                                     config=cfg)
    if mesh.rank != 0:
        return None
    # the float64 checks on rank 0 only: each takes 4-6 copies of A's size,
    # which 8 ranks on one card could not hold at once
    chunk = f.chunk
    del f
    torch.cuda.empty_cache()
    relerr = backward_error_f64(a, qta, r)
    del qta
    res = residuals_f64(a, q, r)
    return dict(chunk=chunk, relerr=relerr, resid=res["relerr"], orth=res["orth"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=256)
    ap.add_argument("--meshes", default="1x1,2x1,4x2", help="comma-separated PRxPC")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--single", action="store_true",
                    help="also the single-device hh qr and torch.linalg.qr")
    ap.add_argument("--seed", type=int, default=0)
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
    kw = dict(n=args.n, nb=args.nb, seed=args.seed, device=args.device)
    for spec in args.meshes.split(","):
        pr, pc = (int(x) for x in spec.split("x"))
        if pr * pc == 1:
            out = errors_rank(Mesh(1, 1), **kw)
            torch.cuda.empty_cache()
        else:
            out = launch.run_world(errors_rank, pr, pc, device=args.device, timeout=1800,
                                   kwargs=kw)
        print(f"sharded {pr}x{pc} {args.n}x{args.n} nb={args.nb} chunk={out['chunk']}: "
              f"relerr {out['relerr']:.3e}, explicit-Q residual {out['resid']:.3e}, "
              f"orth {out['orth']:.3e} [{where}]", flush=True)
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

"""The hr guard on one gaussian draw, panel by panel: the CholeskyQR round-1
orthogonality defect of every panel of the single-card hr factor and of
the sharded hr factor on a 4 × 2 world of ranks, on the same A, and
the single-card factor's worst panel saved as it entered ``hr_panel``.

    python -m tileqr_torch.utils.hr_guard_probe --seed S [S ...] [--n 16384]
        [--out build/hr_guard] [--device cuda]
    python -m tileqr_torch.utils.hr_guard_probe --replay

A is ``numpy.random.default_rng(S).standard_normal((n, n))`` in fp32 (the
draw ``chip_smoke.py``'s phase 11 makes from its seed; ``--device cpu``
and a small n run the same on the CPU's plain versions), factored with
``hr_guard="warn"`` so that a trip keeps the hr factors. The sharded
world's ranks share the card, as in ``chip_smoke.py``. The saved panel
(``hr_panel<k>_seed<S>.npy``) goes to the CPU, where
``tests/test_torch_hr_guard_contract.py PANEL.npy`` prints its condition
number and the defect of tileqr's ``hr_panel`` and the port's on it.

``--replay`` prints, with no card, the seeds ``chip_smoke.py`` gives its
phases 10 and 11 by replaying its shared generator's draws: as it draws
them, and with a (64, 256, 512) stack drawn from it in phase 8 as well.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

import tileqr_torch
from tileqr_torch.drivers import sharded_hr, square_hr

_CHUNK = 1 << 24
# chip_smoke.py's sizes: N, N_HR, (M_TS, N_TS), (B_BA, N_BA), N_SH, and its mesh
N, N_HR, M_TS, N_TS, B_BA, N_BA, N_SH = 8192, 16384, 1048576, 512, 4096, 128, 16384
MESH = (4, 2)


def _gaussian(seed: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, n), dtype=np.float32)).to(device)


def single(seed: int, n: int, device, save: int = -1):
    """(health, per-panel defects, the input of panel ``save`` or None)."""
    a = _gaussian(seed, n, device)
    defects, kept = [], {}
    orig = square_hr.hr_panel

    def recorded(panel, stats=False):
        if len(defects) == save:
            kept["panel"] = panel.detach().cpu().numpy().copy()
        out = orig(panel, stats=stats)
        defects.append(float(out[3]))
        return out

    square_hr.hr_panel = recorded
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = tileqr_torch.qr_factor(a, tileqr_torch.QRConfig(square_method="hr",
                                                               hr_guard="warn"))
    finally:
        square_hr.hr_panel = orig
    return float(f.health), defects, kept.get("panel")


def sharded_rank(mesh, seed: int, n: int, device: str):
    """Rank side: the sharded hr factor of the draw with each panel's
    defect recorded (rank 0 returns them)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
    a = _gaussian(seed, n, dev)
    defects = []
    orig = sharded_hr._cholqr2_psum

    def recorded(p, m):
        out = orig(p, m)
        defects.append(float(out[3]))
        return out

    sharded_hr._cholqr2_psum = recorded
    cfg = tileqr_torch.QRConfig(mesh_shape=mesh.shape, square_method="hr", hr_guard="warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            f = tileqr_torch.qr_sharded(a, mesh, cfg, mode="factor")
    finally:
        sharded_hr._cholqr2_psum = orig
    return dict(health=float(f.health), defects=defects) if mesh.rank == 0 else None


def replay_seeds(extra_stack: bool):
    """chip_smoke.py's (phase-10 seed, phase-11 seed) from its shared
    generator, default_rng(0), replayed draw by draw in chunks (the same
    stream as single calls)."""
    rng = np.random.default_rng(0)
    draws = [N * N, N * 16, N_HR * N_HR, N_HR * 16, M_TS * N_TS, M_TS * 16,
             B_BA * N_BA * N_BA, 4 * N_BA * N_BA]
    draws += [64 * 256 * 512] if extra_stack else []
    draws += [N * N, N_HR * N_HR, N_SH * N_SH]
    for count in draws:
        while count > 0:
            rng.standard_normal(min(_CHUNK, count), dtype=np.float32)
            count -= _CHUNK
    return int(rng.integers(2 ** 31)), int(rng.integers(2 ** 31))


def _line(defects) -> str:
    return " ".join(f"{x:.2e}" for x in defects)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, nargs="*", default=[])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--out", default="build/hr_guard")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay", action="store_true")
    args = ap.parse_args()
    if args.replay:
        for extra in (False, True):
            seed, seed_hr = replay_seeds(extra)
            print(f"chip_smoke.py seeds{' with the phase-8 stack drawn' if extra else ''}: "
                  f"phase 10 {seed}, phase 11 {seed_hr}", flush=True)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("hr_guard_probe: needs a CUDA device (or --device cpu)")
        return 1
    from tileqr_torch.dist import launch

    os.makedirs(args.out, exist_ok=True)
    for seed in args.seed:
        health, defects, _ = single(seed, args.n, args.device)
        k = int(np.argmax(defects))
        print(f"single-card hr {args.n}² seed {seed}: health {health:.4e}, worst panel {k} "
              f"({defects[k]:.4e}); panels {_line(defects)}", flush=True)
        _, _, panel = single(seed, args.n, args.device, save=k)
        path = os.path.join(args.out, f"hr_panel{k}_seed{seed}.npy")
        np.save(path, panel)
        print(f"saved panel {k} {panel.shape} to {path}", flush=True)
        pr, pc = MESH
        out = launch.run_world(sharded_rank, pr, pc, device=args.device, timeout=900,
                               kwargs=dict(seed=seed, n=args.n, device=args.device))
        d = out["defects"]
        k = int(np.argmax(d))
        print(f"sharded hr {args.n}² on {pr}x{pc} seed {seed}: health {out['health']:.4e}, "
              f"worst panel {k} ({d[k]:.4e}); panels {_line(d)}", flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

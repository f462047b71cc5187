"""How the sharded path's fp32 errors grow with the mesh, in tileqr and in
tileqr_torch, on the same A.

For a gaussian fp32 (n, n) A (numpy, the seed's generator) tileqr's
dynamic sharded driver runs on the 8-virtual-device CPU mesh (Pallas in
interpret mode) and the port's ``qr_sharded`` with ``driver="dynamic"``
(plain versions, a gloo world of CPU processes; a (1, 1) mesh in this
process), both at the default chunk. Each gives relerr ‖QᵀA − R‖F/‖A‖F,
the explicit-Q residual ‖A − QR‖F/‖A‖F with Q = apply_q(f, I,
trans=False) and ‖QᵀQ − I‖F, in float64.

The test holds the port's three errors to tileqr's within 10% on each
mesh at 128², nb = 16, so the residual's growth with the mesh rows is
tileqr's. As a script it prints them, and each mesh's residual over the
first mesh's, at a size of choice:

    python tests/test_torch_sharded_growth.py --n 1024 --nb 64 --seeds 0,1,2 \\
        --meshes 1x1,2x1,4x2
"""

import argparse
import os
import sys

if __name__ == "__main__":  # the suite's conftest does this under pytest
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import tileqr  # noqa: E402
from tileqr.drivers import sharded_dyn as jdyn  # noqa: E402
from tileqr_torch.dist import launch  # noqa: E402
from tileqr_torch.dist.mesh import Mesh  # noqa: E402
from tileqr_torch.utils.sharded_errors import errors_rank, gaussian  # noqa: E402


def tileqr_errors(a: np.ndarray, mesh_shape, nb: int) -> dict:
    mesh = jax.make_mesh(mesh_shape, ("rows", "cols"))
    cfg = tileqr.QRConfig(nb=nb, ib=min(128, nb), mesh_shape=mesh_shape, driver="dynamic")
    f = jdyn.qr_sharded_factor_dyn(a, mesh, cfg)
    r = np.asarray(jdyn.assemble_r_sharded_dyn(f, mesh), np.float64)
    qta = np.asarray(jdyn.apply_q_sharded_dyn(f, a, mesh, True, cfg), np.float64)
    eye = np.eye(a.shape[0], dtype=np.float32)
    q = np.asarray(jdyn.apply_q_sharded_dyn(f, eye, mesh, False, cfg), np.float64)
    a64 = a.astype(np.float64)
    na = np.linalg.norm(a64)
    qta[: r.shape[0]] -= r
    return dict(chunk=f.chunk, relerr=np.linalg.norm(qta) / na,
                resid=np.linalg.norm(a64 - q @ r) / na,
                orth=np.linalg.norm(q.T @ q - np.eye(q.shape[1])))


def port_errors(mesh_shape, n: int, nb: int, seed: int) -> dict:
    kw = dict(n=n, nb=nb, seed=seed, device="cpu", driver="dynamic")
    pr, pc = mesh_shape
    if pr * pc == 1:
        return errors_rank(Mesh(1, 1), **kw)
    return launch.run_world(errors_rank, pr, pc, device="cpu", timeout=1800, kwargs=kw)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (4, 2)], ids=["1x1", "2x1", "4x2"])
def test_fp32_errors_match_tileqr(mesh_shape):
    n, nb, seed = 128, 16, 4
    want = tileqr_errors(gaussian(n, seed, "cpu").numpy(), mesh_shape, nb)
    got = port_errors(mesh_shape, n, nb, seed)
    assert got["chunk"] == want["chunk"]
    for k in ("relerr", "resid", "orth"):
        assert abs(got[k] - want[k]) <= 0.1 * want[k], k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--nb", type=int, default=32)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--meshes", default="1x1,2x1,4x2")
    args = ap.parse_args()
    meshes = [tuple(int(x) for x in s.split("x")) for s in args.meshes.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        a = gaussian(args.n, seed, "cpu").numpy()
        base = {}
        for shape in meshes:
            for pkg, fn in (("tileqr", lambda: tileqr_errors(a, shape, args.nb)),
                            ("tileqr_torch", lambda: port_errors(shape, args.n, args.nb, seed))):
                e = fn()
                base.setdefault(pkg, e["resid"])
                print(f"seed {seed} {pkg} {shape[0]}x{shape[1]} {args.n}x{args.n} "
                      f"nb={args.nb} chunk={e['chunk']}: relerr {e['relerr']:.3e}, "
                      f"explicit-Q residual {e['resid']:.3e} "
                      f"({e['resid'] / base[pkg]:.3f} of the first mesh's), "
                      f"orth {e['orth']:.3e} [CPU, fp32]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

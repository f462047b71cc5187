"""Time the whole-panel apply's two phases, the strip apply K3/K4, the hh
and hr factors, B9 and the batched GEQRT's paths for two checkouts of this
repository on one card, in turns, with a hash of each output.

    python -m tileqr_torch.utils.ab_compare --parent DIR [--order parent,change,change,parent]
        [--only apply strip hr tsqr batched cluster]

``DIR`` is another checkout's root (e.g. ``git archive <commit>`` unpacked
into a directory that ``.gitignore`` lists). Each turn is a fresh process
whose ``PYTHONPATH`` is that checkout's root (``change`` is this one), so
each imports its own ``tileqr_torch`` and builds its own kernels. A turn
prints, with its tag, the probes of the groups ``--only`` names (all by
default): "apply", B7a (``panel_project``) and B7b (``panel_sub``) in
every mode on Y 4096×256, C 4096×8192 (the sharded hr path's slice);
"strip", K3 (``couple_strip``) at the hh path's panel 0 of 8192² (7
couples of 1024 rows, 7936 columns) in every mode, and with the LARFB
fused in the Q-apply order in "highest", panel 0's whole sweep
(``strip_sweep``: 3 head couples, 7 chunks) as the narrow update runs it
on 256 columns and as Q's formation runs it in reverse on 256 and 1024
columns, K4 (``larfb_strip``) on that
strip in every mode, and hh ``qr_factor`` 8192² "highest" (a hash of its
factors); "hr", B6 (``panel_apply_carry``) on panel 0 of a gaussian 16384²
A in "highest" and "b3" with the hr panel's Y, T, B9 (``potrf_batched``)
on that panel's gram (1, 256, 256), and hr ``qr_factor`` 16384² "highest"
(hashes of panels 0-46, of panels 47-62 and of R apart); "tsqr",
``geqrt`` on a 256² tile (B1s), the batched GEQRT on the 512 leaves of
1048576×512 and on the tree's level-1 stack of 128 (2048×512 each),
``tsqr`` r on that A at nb = 512, B9 on its cholqr2 factor's gram (1,
512, 512) and B7 in "b3" with that factor's panel (nb = 512); "batched",
the batched GEQRT on a gaussian 4096×128² stack at ib 32 and 128,
``qr_batched`` hh on it, and B9 on the gram of G + 4·√128·I (4096, 128,
128, the cholqr2 route's); "cluster", the cluster routine's other users at
the main path's shapes: K1 alone (3 couples) and K2 (7 chunks of 1024 rows,
pipelined; 1 chunk, the serial loop) on an 8192×256 panel, TTQRT at nb 256
and 512, the tsqr tree's level-2 to level-5 stacks, and B8 at nb 256 and
512 (inputs from ``default_rng(5)``). Times: CUDA events over warm calls, the mean
of each reading's calls, several readings. Inputs come from
``numpy.random.default_rng(0)`` (the batched group's from
``default_rng(4)``), the same in every turn and whichever groups run, so
equal hashes mean bitwise equal outputs. Only public entry points both commits have
are called. The card's name and power limit from nvidia-smi head the
output. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over reps warm calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def readings(fn, reps: int, repeat: int) -> str:
    return "/".join(f"{cuda_ms(fn, reps):.4f}" for _ in range(repeat)) + " ms"


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


GROUPS = ("apply", "strip", "hr", "tsqr", "batched", "cluster")
# the inputs each group draws from numpy.random.default_rng(0), in order: a
# group's stream skips the draws of the groups before it, so a group's
# inputs are the same whichever groups run (B7a/B7b's Y, C, W; the hh A; the
# hr A; the 256² tile and the tsqr A)
DRAWS = {"apply": [(4096, 256), (4096, 8192), (256, 8192)], "strip": [(8192, 8192)],
         "hr": [(16384, 16384)], "tsqr": [(256, 256), (1048576, 512)]}


def stream(group: str) -> np.random.Generator:
    """numpy's default_rng(0) past the draws of the groups before ``group``."""
    rng = np.random.default_rng(0)
    for g in GROUPS[:GROUPS.index(group)]:
        for shape in DRAWS.get(g, ()):
            rng.standard_normal(shape, dtype=np.float32)
    return rng


def turn(tag: str, only) -> None:
    """One checkout's probes (the package on sys.path is that checkout's)."""
    import tileqr_torch
    from tileqr_torch.drivers import cholqr, square_hr
    from tileqr_torch.kernels import _build, geqrt, potrf
    from tileqr_torch.kernels import panel_apply as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{tag}: tileqr_torch from {Path(tileqr_torch.__file__).parent}", flush=True)
    _build.lib()

    def b9(g, what):
        print(f"{tag} B9 {what} {tuple(g.shape)}: "
              f"{readings(lambda: potrf.potrf_batched(g), 20, 3)}, "
              f"hash {digest(potrf.potrf_batched(g))}", flush=True)

    if "apply" in only:
        rng = stream("apply")
        y = torch.from_numpy(rng.standard_normal((4096, 256), dtype=np.float32)).cuda() / 64
        c = torch.from_numpy(rng.standard_normal((4096, 8192), dtype=np.float32)).cuda()
        for mode in ("highest", "b3", "b4", "default"):
            w = pa.panel_project(y, c, mode)
            print(f"{tag} B7a {mode}: {readings(lambda: pa.panel_project(y, c, mode), 20, 3)}, "
                  f"hash {digest(w)}", flush=True)
        w = torch.from_numpy(rng.standard_normal((256, 8192), dtype=np.float32)).cuda()
        for mode in ("highest", "b3", "b4", "default"):
            out = pa.panel_sub(y, w, c.clone(), mode)
            cw = c.clone()
            print(f"{tag} B7b {mode}: {readings(lambda: pa.panel_sub(y, w, cw, mode), 20, 3)}, "
                  f"hash {digest(out)}", flush=True)
        del y, c, w, out, cw

    if "strip" in only:
        from tileqr_torch.kernels import chain, panel

        rng = stream("strip")
        n, nb = 8192, 256
        a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).cuda()
        r, v_stack, tg, t2h = panel.panel_factor(a, 0, nb, 128, 3)
        _, v_chunks, t2 = chain.panel_chain(a, r, 0, nb, 1, 7, 4 * nb, 128)
        for mode, rev in (("highest", False), ("highest", True), ("b3", False), ("b4", False),
                          ("default", False)):
            kw = dict(trans=not rev, reverse=rev, precision=mode)
            if rev:
                kw.update(vkk=v_stack[0], tg=tg)
            out = a.clone()
            chain.couple_strip(v_chunks, t2, out, out[:nb, nb:], 0, 1, 7, 4 * nb, nb, 1, **kw)
            h = digest(out)
            cw = a.clone()
            ms = readings(lambda: chain.couple_strip(v_chunks, t2, cw, cw[:nb, nb:], 0, 1, 7,
                                                     4 * nb, nb, 1, **kw), 10, 3)
            print(f"{tag} K3 panel 0 {mode}{' reverse fused' if rev else ''}: {ms}, hash {h}",
                  flush=True)
            del out, cw
        # panel 0's sweep as the driver runs it on narrow strips: the narrow
        # update (column tile 1: heads with the LARFB, then chunks), and
        # Q's reverse sweep (chunks, then heads with the LARFB) on 256 and
        # 1024 columns
        for label, width, trans in (("narrow update", nb, True), ("Q sweep", nb, False),
                                    ("Q sweep", 4 * nb, False)):
            cs = 1 if trans else 0

            def sweep(m, cs=cs, width=width, trans=trans):
                c = m[:, : cs * nb + width]
                strip = c[:nb, cs * nb :]
                chain.strip_sweep((v_stack, t2h, c, strip, 1, 1, 3, nb, nb, cs),
                                  (v_chunks, t2, c, strip, 0, 1, 7, 4 * nb, nb, cs),
                                  v_stack[0], tg, strip, nb, trans=trans)

            out = a[:, : cs * nb + width].clone()
            sweep(out)
            h = digest(out)
            cw = out.clone()
            print(f"{tag} K3 panel 0 {label} on {width} columns: "
                  f"{readings(lambda: sweep(cw), 20, 3)}, hash {h}", flush=True)
            del out, cw
        for mode in ("highest", "b3", "b4", "default"):
            s = a[:nb, nb:].clone()
            chain.larfb_strip(v_stack[0], tg, s, nb, precision=mode)
            h = digest(s)
            ms = readings(lambda: chain.larfb_strip(v_stack[0], tg, s, nb, precision=mode), 20, 3)
            print(f"{tag} K4 {mode}: {ms}, hash {h}", flush=True)
        f = tileqr_torch.qr_factor(a)
        h = digest(f.packed, f.r_diag, f.t_geqrt)
        del f
        print(f"{tag} hh qr_factor {n}² highest: "
              f"{readings(lambda: tileqr_torch.qr_factor(a), 2, 3)}, hash {h}", flush=True)
        del a, r, v_stack, tg, t2h, v_chunks, t2, s
        torch.cuda.empty_cache()

    if "hr" in only:
        rng = stream("hr")
        n, nb = 16384, 256
        a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).cuda()
        with square_hr._highest():
            y, t, _ = square_hr.hr_panel(a[:, :nb])
            for mode in ("highest", "b3"):
                out = a.clone()
                pa.panel_apply_carry(y, t, out, 0, nb, precision=mode)
                h = digest(out[:, nb:])
                ms = readings(lambda: pa.panel_apply_carry(y, t, out, 0, nb, precision=mode), 5, 3)
                print(f"{tag} B6 panel 0 {mode}: {ms}, hash {h}", flush=True)
                del out
            b9(square_hr.hr_panel_parts(a[:, :nb])["gram"], "hr panel 0 gram")
            cfg = tileqr_torch.QRConfig(square_method="hr")
            f = tileqr_torch.qr_factor(a, cfg)
            hashes = (digest(*[x for p in f.panels[:47] for x in p]),
                      digest(*[x for p in f.panels[47:] for x in p]), digest(f.r))
            del f
            print(f"{tag} hr qr_factor {n}² highest: "
                  f"{readings(lambda: tileqr_torch.qr_factor(a, cfg), 2, 2)}, hash panels 0-46 "
                  f"{hashes[0]}, panels 47-62 {hashes[1]}, R {hashes[2]}", flush=True)
        del a, y, t
        torch.cuda.empty_cache()

    if "tsqr" in only:
        rng = stream("tsqr")
        tile = torch.from_numpy(rng.standard_normal((256, 256), dtype=np.float32)).cuda()
        print(f"{tag} B1s geqrt 256²: {readings(lambda: geqrt.geqrt(tile), 20, 3)}, "
              f"hash {digest(*geqrt.geqrt(tile))}", flush=True)
        a = torch.from_numpy(rng.standard_normal((1048576, 512), dtype=np.float32)).cuda()
        leaves = a.view(512, 2048, 512)
        pk, tl = geqrt.geqrt_batched(leaves, 128)
        print(f"{tag} B10 leaves {tuple(leaves.shape)}: "
              f"{readings(lambda: geqrt.geqrt_batched(leaves, 128), 1, 3)}, "
              f"hash {digest(pk, tl)}", flush=True)
        level1 = torch.triu(pk[:, :512]).reshape(128, 2048, 512)
        del pk, tl
        print(f"{tag} B10 level 1 {tuple(level1.shape)}: "
              f"{readings(lambda: geqrt.geqrt_batched(level1, 128), 1, 3)}, "
              f"hash {digest(*geqrt.geqrt_batched(level1, 128))}", flush=True)
        del level1
        torch.cuda.empty_cache()
        cfg = tileqr_torch.QRConfig(nb=512)
        print(f"{tag} tsqr r 1048576×512: "
              f"{readings(lambda: tileqr_torch.tsqr(a, 'r', cfg), 3, 2)}, "
              f"hash {digest(tileqr_torch.tsqr(a, 'r', cfg))}", flush=True)
        with square_hr._highest():
            b9(square_hr.hr_panel_parts(a)["gram"], "tsqr cholqr2 gram")
        y, t = tileqr_torch.tsqr(a, "factor", cfg).panels[0]
        with square_hr._highest():
            out = a.clone()
            print(f"{tag} B7 b3 nb=512 on the tsqr factor's panel: "
                  f"{readings(lambda: pa.panel_apply(y, t, out, precision='b3'), 1, 2)}",
                  flush=True)
        del a, y, t, out
        torch.cuda.empty_cache()

    if "batched" in only:
        rng = np.random.default_rng(4)
        a = torch.from_numpy(rng.standard_normal((4096, 128, 128), dtype=np.float32)).cuda()
        for ib in (32, 128):
            print(f"{tag} geqrt_batched (4096, 128, 128) ib={ib}: "
                  f"{readings(lambda: geqrt.geqrt_batched(a, ib), 5, 3)}, "
                  f"hash {digest(*geqrt.geqrt_batched(a, ib))}", flush=True)
        cfg = tileqr_torch.QRConfig()
        print(f"{tag} qr_batched hh (4096, 128, 128): "
              f"{readings(lambda: tileqr_torch.qr_batched(a, config=cfg), 5, 3)}, "
              f"hash {digest(*tileqr_torch.qr_batched(a, config=cfg))}", flush=True)
        wc = a + 4 * float(np.sqrt(128)) * torch.eye(128, device=a.device)
        with cholqr._highest():
            b9(cholqr.bdot_pair_rows(wc, wc), "qr_batched cholqr2 gram")
        del a, wc
        torch.cuda.empty_cache()

    if "cluster" in only:
        from tileqr_torch.kernels import chain, modlu, panel, ttqrt

        rng = np.random.default_rng(5)
        nb = 256
        a = torch.from_numpy(rng.standard_normal((8192, nb), dtype=np.float32)).cuda()
        r_k = torch.triu(a[:nb])
        calls = {
            "K1 (3 couples, pipelined)": lambda: panel.panel_factor(a, 0, nb, 128, 3),
            "K2 (7 chunks of 1024, pipelined)": lambda: chain.panel_chain(a, r_k, 0, nb, 1, 7,
                                                                          4 * nb, 128),
            "K2 (1 chunk of 1024, serial)": lambda: chain.panel_chain(a, r_k, 0, nb, 1, 1,
                                                                      4 * nb, 128),
        }
        for n in (256, 512):
            r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((n, n), dtype=np.float32)))
                      .cuda() for _ in range(2))
            calls[f"TTQRT {n}"] = lambda r1=r1, r2=r2: ttqrt.ttqrt(r1, r2, 128)
        for b in (32, 8, 2, 1):  # the tsqr tree's levels 2-5 at 1048576×512
            s = torch.from_numpy(rng.standard_normal((b, 2048 if b > 1 else 1024, 512),
                                                     dtype=np.float32)).cuda()
            calls[f"tree level stack {tuple(s.shape)}"] = (
                lambda s=s: geqrt.geqrt_batched(s, 128))
        for n in (256, 512):
            q, _ = torch.linalg.qr(torch.from_numpy(rng.standard_normal((4 * n, n))).cuda())
            q_top = q[:n].float().contiguous()
            calls[f"B8 modified_lu {n}"] = lambda q_top=q_top: modlu.modified_lu(q_top)
        for name, fn in calls.items():
            print(f"{tag} {name}: {readings(fn, 5, 3)}, hash {digest(*fn())}", flush=True)
        del a, r_k, calls
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--only", nargs="*", choices=GROUPS, default=list(GROUPS))
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # set for the child processes
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_compare: needs a CUDA device", file=sys.stderr)
        return 1
    if args.turn:
        turn(args.turn, args.only)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    roots = {"parent": Path(args.parent).resolve(), "change": ROOT}
    for tag in args.order.split(","):
        env = dict(os.environ, PYTHONPATH=str(roots[tag]))
        # this file run by path with -P (its own directory, which holds a
        # profile.py, is not put on sys.path): the child imports tileqr_torch
        # from the turn's checkout only
        rc = subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--turn", tag,
                             "--only", *args.only], env=env, cwd=roots[tag]).returncode
        if rc:
            print(f"ab_compare: the {tag} turn exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Readings for the limits of ``correct``: the judge's numbers of the
program and of the control, at a cell's own size, over many seeds in one
process.

    python3 -m qrbench.calibrate --workload square-8192.qr --seeds 1 2 3 \\
        --control-seeds 11 12 13 [--extra fp32 b3] [--out FILE]

For each seed the input is pool member 0 of that seed, the matrix that a
run with the seed judges first. "program" is the cell's call; "control" is
the plain reference put in the program's place and computed in TF32, the
nearest precision below the configurations' IEEE fp32 (it has to come out
not correct). ``--extra`` adds, for the record, "fp32" (the reference in
IEEE fp32, an honest fp32 QR that has to come out correct) and "b3" (the
program in its own split-bf16 mode "b3", the square cell's second
control: it has to come out not correct as well). Each reading is one JSON
line with its verdict by the cell's limits (``judge.verdict``, as a run
decides); the last lines give each side's largest and smallest number and
the limits.
"""

from __future__ import annotations

import argparse
import json
import time

from qrbench import spec
from qrbench.run import set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--extra", nargs="*", default=[], choices=("fp32", "b3"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(spec.ROOT), help="the checkout (tests)")
    args = ap.parse_args(argv)
    set_cache_dirs(spec.ROOT)
    import torch

    from qrbench.judge import verdict
    from qrbench.workload import make_call, make_member

    c = spec.cell(args.workload, args.root)
    ref = c.reference
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    call = make_call(c)
    b3 = None
    if "b3" in args.extra:
        b3 = make_call(c._replace(config=dict(
            c.config, qrconfig=dict(c.config["qrconfig"], precision="b3"))))
    lines = []
    warm = set()

    def reading(side, seed, fn, a, r_ref):
        t0 = time.perf_counter()
        got = fn(a)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        nums = c.call.numbers(a, got, r_ref)
        checks = verdict(nums, c.limits)
        rec = {"side": side, "seed": seed, "ms": ms, **nums,
               "correct": all(ch["ok"] for ch in checks.values())}
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    plan = [(s, ["program"] + [x for x in args.extra]) for s in args.seeds]
    plan += [(s, ["control"]) for s in args.control_seeds]
    for seed, sides in plan:
        a = make_member(c, seed, 0, args.device)
        t0 = time.perf_counter()
        r_ref = c.call.truth(ref, a)
        sync()
        print(json.dumps({"reference_ms": (time.perf_counter() - t0) * 1e3, "seed": seed}))
        for side in sides:
            if side in ("program", "b3"):
                fn = call if side == "program" else b3
                try:
                    if side not in warm:
                        fn(a)
                        sync()
                        warm.add(side)
                    reading(side, seed, lambda x, fn=fn: c.call.answer(fn(x)), a, r_ref)
                except ValueError as e:  # a mode the entry refuses
                    print(json.dumps({"side": side, "seed": seed, "refused": str(e)}))
            else:
                prec = "tf32" if side == "control" else "ieee"
                reading(side, seed, lambda x, p=prec: c.call.reference(ref, x, p), a, r_ref)
        del a, r_ref
    summary = {}
    for rec in lines:
        s = summary.setdefault(rec["side"], {})
        for k, v in rec.items():
            if k in ("side", "seed", "ms", "correct"):
                continue
            lo, hi = s.get(k, (v, v))
            s[k] = (min(lo, v), max(hi, v))
    for side, s in summary.items():
        mine = [r for r in lines if r["side"] == side]
        print(json.dumps({"summary": side, "n": len(mine),
                          "n_correct": sum(r["correct"] for r in mine),
                          "min_max": s, "limits": c.limits}))
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps({"workload": args.workload, **rec}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

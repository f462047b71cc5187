"""Run one cell of the benchmark once, on the card it is started on.

    python3 -m qrbench.run --workload square-8192.qr --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``qrbench/`` and
the program, ``tileqr_torch``. The cell's inputs are made on the card from
the seed; its call is warmed, then driven in a closed loop (one caller, one
call in flight, each call ended by ``torch.cuda.synchronize()``) for
``--seconds``. With ``--trace 1`` whole calls after the window run once
more under torch.profiler, and the cell's per-layer metrics are printed
instead of its end-to-end ones. After the window and the card's peak
memory reading, the outputs of the first call on each input of the pool,
of the last call and of a sample of the others drawn from the seed are
judged in float64 against the plain reference, by the numbers of the
cell's call module (``calls/``, ``judge.py``), and ``correct`` says whether
every number met its limit.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit); the checks are also the last lines of standard error. Without a
CUDA card, or with fewer than the cell's chips, it prints no result and
exits 2; it exits 3 if JAX or the JAX package was loaded, 1 on any other
failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, TextIO  # noqa: E402

from qrbench import lawn41, spec  # noqa: E402

# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "tileqr")
POOL = 4  # distinct inputs a run cycles through
WARM = 2  # warm calls in set-up, on the pool's first members
JUDGE_SAMPLE = 4  # answers judged besides each input's first and the last
TRACE_SECONDS = 1.5  # the traced sub-window of whole calls (--trace 1) lasts
TRACE_CALLS = 3  # at least this long and this many calls


def forbidden_loaded(names=None) -> List[str]:
    """FORBIDDEN names among the top-level names (the part before the first
    dot, compared whole) of the loaded modules."""
    names = sys.modules if names is None else names
    tops = {n.split(".")[0] for n in names}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its own library under ``build/tileqr_torch/<hash>``
    beside its package; these cover torch's extension and Triton caches."""
    build = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Record:
    """What a metric reader reads: the window's calls, the cell's work per
    call, set-up, the judged backward error and the trace."""

    def __init__(self, flops: float, nbytes: float):
        self.flops_per_call = flops
        self.least_s = lawn41.least_seconds(flops, nbytes)
        # (start, return, end) on the host clock, ok
        self.calls: List[tuple] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.backward_error: Optional[float] = None
        self.trace: Optional[dict] = None


class Sample:
    """The window's outputs that are judged: the first call on each pool
    member, the last call and a reservoir of ``k`` of the others, drawn
    with ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng = k, rng
        self.firsts: Dict[int, tuple] = {}
        self.last = None
        self.pool: List[tuple] = []
        self.offered = 0

    def add(self, index: int, member: int, out) -> None:
        item = (index, member, out)
        if member not in self.firsts:
            self.firsts[member] = item
            return
        if self.last is not None:
            self._offer(self.last)
        self.last = item

    def _offer(self, item) -> None:
        if len(self.pool) < self.k:
            self.pool.append(item)
        else:
            j = self.rng.randrange(self.offered + 1)
            if j < self.k:
                self.pool[j] = item
        self.offered += 1

    def items(self) -> List[tuple]:
        got = list(self.firsts.values()) + self.pool + [self.last]
        return sorted((it for it in got if it is not None), key=lambda it: it[0])


def _card_lines() -> List[str]:
    q = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu"
    try:
        proc = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"card: nvidia-smi unavailable ({e})"]
    return [f"card ({q}): {line}" for line in proc.stdout.strip().splitlines()]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = spec.ROOT, out: TextIO = sys.stdout,
             err: TextIO = sys.stderr) -> dict:
    """Run the cell once and return its result (the last line's object).
    ``device`` "cpu" runs the program's plain versions (tests only)."""
    import torch

    from qrbench.judge import verdict
    from qrbench.workload import make_call, make_member, make_pool

    c = spec.cell(name, root)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    shape = tuple(c.config["shape"])
    itemsize = torch.empty((), dtype=getattr(torch, c.config["dtype"])).element_size()
    rec = Record(c.call.flops(shape), c.call.least_bytes(shape, itemsize))

    import tileqr_torch  # noqa: F401  (set-up: the program's import)
    from tileqr_torch.kernels import _build

    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
        _build.lib()
    pool = make_pool(c, seed, POOL, device)
    call = make_call(c)
    for i in range(WARM):
        res = call(pool[i % len(pool)])
        sync()
        del res
    sync()
    before = dict(_build.LAUNCHES)

    sample = Sample(JUDGE_SAMPLE, random.Random(seed))
    failed, first_error = 0, None
    t_win = time.perf_counter()
    rec.setup_s = t_win - T_START
    i = 0
    while True:
        member = i % len(pool)
        t0 = time.perf_counter()
        try:
            res = call(pool[member])
            t1 = time.perf_counter()
            sync()
            ok = True
        except Exception:  # a call that fails is counted, and the loop goes on
            t1 = time.perf_counter()
            ok, res = False, None
            failed += 1
            if first_error is None:
                first_error = traceback.format_exc()
        t2 = time.perf_counter()
        rec.calls.append((t0, t1, t2, ok))
        if ok:
            sample.add(i, member, res)
        del res
        i += 1
        if t2 - t_win >= seconds:
            break
    rec.window_s = rec.calls[-1][2] - t_win
    path = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
            if v != before.get(k, 0)}
    print(f"window: {len(rec.calls)} calls in {rec.window_s:.6f} s; kernel wrapper "
          f"launches per call (path taken): "
          + json.dumps({k: v / len(rec.calls) for k, v in sorted(path.items())}), file=out)
    if first_error:
        print(f"first failed call:\n{first_error}", file=err)

    if trace:
        from qrbench.trace import run_traced

        rec.trace = run_traced(call, pool, i, TRACE_SECONDS, TRACE_CALLS, sync, device)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pool, call
    if cuda:
        torch.cuda.empty_cache()

    # the judge: the reference's result on each member once, every sampled answer
    numbers: Dict[str, float] = {}
    judged, judge_error = 0, None
    truths: Dict[int, object] = {}
    items = sample.items()
    judged_calls = [it[0] for it in items]
    del sample
    try:
        for _, member, res in items:
            a = make_member(c, seed, member, device)
            if member not in truths:
                truths[member] = c.call.truth(c.reference, a)
            got = c.call.numbers(a, c.call.answer(res), truths[member])
            judged += 1
            for key, v in got.items():
                prev = numbers.get(key, -math.inf)
                numbers[key] = v if not math.isfinite(v) or v > prev else prev
            del a
    except Exception:  # an answer the judge cannot read is a wrong answer
        judge_error = traceback.format_exc()
        print(f"judge failed:\n{judge_error}", file=err)
    del items
    if numbers:
        rec.backward_error = numbers.get(c.call.BACKWARD)

    checks = verdict(numbers, c.limits)
    correct = (failed == 0 and 0 < judged == len(judged_calls) and judge_error is None
               and bool(checks)
               and all(ch["ok"] for ch in checks.values()))

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = spec.load("metrics", m["name"], root).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c.workload["chips"] if cuda else 0,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(rec.calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace:
        print(f"trace: {rec.trace['n_calls']} calls, {rec.trace.get('n_ops', 0)} device "
              f"operations", file=out)
        if rec.trace.get("n_ops"):
            dev["busy_s"] = rec.trace["busy_s"]
            dev["window_s"] = rec.trace["window_s"]
            result["breakdown"] = rec.trace["breakdown"]
    result["checks"] = {k: {"value": ch["value"], "limit": ch["limit"]}
                        for k, ch in checks.items()}
    if cuda:
        for line in _card_lines():
            print(line, file=out)
    print(f"judged {judged} answers, calls {judged_calls}; numbers {numbers}", file=out)
    for key, ch in checks.items():
        print(f"check {key} {ch['value']} limit {ch['limit']}"
              f" {'ok' if ch['ok'] else 'FAILED'}", file=err)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(spec.ROOT)
    c = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.workload["chips"]:
        print(f"qrbench: {args.workload} needs {c.workload['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"qrbench: loaded in the process that prints the result: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

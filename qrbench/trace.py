"""A torch.profiler trace of whole calls, reduced to what the per-layer
metrics and the ``breakdown`` read.

``OWN`` and ``group_of`` are a frozen copy of
``tileqr_torch/utils/profile.py``'s, so that the breakdown's groups cannot
move with the program. The idle share is taken over the traced window as
one minus the union of the device operations' intervals (kernels, copies
and sets), which holds where operations overlap as well.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence

import torch

CALL = "qrbench.call"
WARM = "qrbench.warm"
TOP = 10

OWN = {
    "panel_factor_kernel": "panel_factor",
    "panel_chain_kernel": "panel_chain",
    "proj_f32_kernel": "couple_strip (K3 stage 1, projections)",
    "proj_wg_kernel": "couple_strip (K3 stage 1, projections, split product)",
    "chain_kernel": "couple_strip/larfb_strip (K3 stage 2 and K4, the chain)",
    "modlu_kernel": "modified_lu",
    "potrf_cluster_kernel": "potrf_batched",
    "project_f32_kernel": "panel apply B6/B7/B7a (phase 1)",
    "project_wg_kernel": "panel apply B6/B7/B7a (phase 1, split product)",
    "combine_kernel": "panel apply B6/B7 (phase 1's groups combined, op(T) folded in)",
    "sub_f32_kernel": "C -= Y W: B6/B7/B7b phase 2 and K3 stage 3",
    "sub_wg_kernel": "C -= Y W: B6/B7/B7b phase 2 and K3 stage 3 (split product)",
    "geqrt_batched_kernel": "geqrt_batched",
    "geqrt_cluster_kernel": "geqrt_batched (cluster route)",
    "geqrt_small_kernel": "geqrt_batched (small route)",
    "geqrt_tall_kernel": "geqrt_batched (tall route)",
    "Memcpy": "copies (Memcpy)",
    "ttqrt_kernel": "ttqrt",
}


def group_of(name: str) -> str:
    for frag, g in OWN.items():
        if frag in name:
            return g
    if "gemm" in name.lower() or "xmma" in name or "cutlass" in name.lower():
        return "torch.matmul (cuBLAS)"
    return "other torch ops"


def run_traced(call: Callable, pool: Sequence, start: int, min_seconds: float,
               min_calls: int, sync: Callable, device_type: str) -> dict:
    """One warm call, then whole calls until both minimums are met, under
    the profiler; returns ``reduce``'s summary."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    n = 0
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WARM):
            out = call(pool[start % len(pool)])
            sync()
        del out
        t0 = time.perf_counter()
        while n < min_calls or time.perf_counter() - t0 < min_seconds:
            with torch.profiler.record_function(CALL):
                out = call(pool[(start + 1 + n) % len(pool)])
                sync()
            del out
            n += 1
    return reduce(prof.events(), n)


def _union(intervals: List[List[float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("qrbench."))


def reduce(events, n_calls: int) -> dict:
    """busy_s, window_s, n_ops, n_calls and the breakdown of the traced
    calls (times in seconds; the profiler's are in µs)."""
    spans = [e for e in events if e.name == CALL
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        return {"n_calls": 0}
    w0 = min(e.time_range.start for e in spans)
    w1 = max(e.time_range.end for e in spans)
    ops = []
    for e in events:
        if _is_device(e) and e.time_range.end > w0 and e.time_range.start < w1:
            ops.append((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name))
    busy = _union([[s, e] for s, e, _ in ops])
    by_group: Dict[str, float] = defaultdict(float)
    for s, e, name in ops:
        by_group[group_of(name)] += (e - s) / 1e6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and not e.name.startswith("qrbench.")))
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        by_host[_host_at(host, starts, (s + e) / 2)] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "n_calls": n_calls,
        "n_ops": len(ops),
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "breakdown": {"device_ops": top(by_group), "idle_gaps": top(by_host)},
    }


def _host_at(host, starts, t: float, scan: int = 4096) -> str:
    """The innermost host operation running at time t: the latest-starting
    one that still covers it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host (no profiled op)"

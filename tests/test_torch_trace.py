"""The port's phase spans (``core/trace.py``) on the CPU: the no-op with no
profiler, the names, nesting and counts that each entry records under
torch.profiler, results bitwise equal with and without it, the guard's
counter ``trace.GUARD``, and ``utils/profile.span_times``, which charges
device time to the spans, on synthetic events and on a real CPU trace."""

import collections
import types
import warnings

import pytest
import torch

import tileqr_torch as tq
from tileqr_torch.core import trace
from tileqr_torch.drivers import tsqr as tsqr_driver
from tileqr_torch.kernels import _build
from tileqr_torch.utils.profile import _nest, kernel_times, span_times

P = "tileqr_torch."
SQ = tq.QRConfig(nb=64, ib=32, chunk=2)  # 256² is 4 panels, 3 updates, 2 of them split
HR = tq.QRConfig(nb=64, ib=32, square_method="hr")
TALL = tq.QRConfig(nb=64, ib=32)  # 65536×64: 4 leaves of 16384 rows, one level


def _a(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float32)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _spans(events):
    """(name, parent name or None) of each program span, in start order."""
    sp = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.name.startswith(P)), key=lambda s: (s[0], -s[1]))
    return [(s[2], None if p is None else sp[p][2]) for s, p in zip(sp, _nest(sp))]


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):  # factor records are NamedTuples
        return [t for y in x for t in _flat(y)]
    return []


SQA, TALLA = _a(256, 256), _a(65536, 64, seed=1)
HRA = _a(256, 256, seed=2) + 64 * torch.eye(256)  # G + 4·√n·I: the guard holds
B = _a(256, 3, seed=3)
STACK = _a(8, 64, 16, seed=4)
SHIFTED = _a(6, 40, 36, seed=6) + 24 * torch.eye(40, 36)  # G + 4·√n·I, each member

# (call, {span: count}, {span: its parent})
CASES = {
    "qr": (lambda: tq.qr(SQA, config=SQ),
           {"qr": 1, "qr_factor": 1, "prep": 1, "hh.panel": 4, "hh.update": 5,
            "assemble_r": 1, "orgqr": 1},
           {"qr": None, "qr_factor": "qr", "prep": "qr_factor", "hh.panel": "qr_factor",
            "hh.update": "qr_factor", "assemble_r": "qr", "orgqr": "qr"}),
    "qr_hr": (lambda: tq.qr(HRA, config=HR),
              {"qr": 1, "qr_factor": 1, "prep": 1, "hr.round1": 4, "hr.round2": 4,
               "hr.reconstruct": 4, "hr.update": 3, "sync.guard": 1, "assemble_r": 1,
               "orgqr": 1, "hr.apply": 4},
              {"hr.round1": "qr_factor", "hr.update": "qr_factor", "sync.guard": "qr_factor",
               "orgqr": "qr", "hr.apply": "orgqr"}),
    "lstsq_hr": (lambda: tq.lstsq(HRA, B, config=HR),
                 {"lstsq": 1, "qr_factor": 1, "prep": 1, "hr.round1": 4, "hr.round2": 4,
                  "hr.reconstruct": 4, "hr.update": 3, "sync.guard": 1, "apply_q": 1,
                  "hr.apply": 4, "assemble_r": 1},
                 {"hr.update": "qr_factor", "apply_q": "lstsq", "hr.apply": "apply_q"}),
    "lstsq": (lambda: tq.lstsq(SQA, B, config=SQ),
              {"lstsq": 1, "qr_factor": 1, "prep": 1, "hh.panel": 4, "hh.update": 5,
               "apply_q": 1, "assemble_r": 1},
              {"qr_factor": "lstsq", "apply_q": "lstsq", "assemble_r": "lstsq"}),
    "tsqr_r_tree": (lambda: tq.tsqr(TALLA, "r", TALL, strategy="tree"),
                    {"tsqr": 1, "prep": 1, "tree.leaves": 1, "tree.level": 1},
                    {"prep": "tsqr", "tree.leaves": "tsqr", "tree.level": "tsqr"}),
    "tsqr_reduced_tree": (lambda: tq.tsqr(TALLA, "reduced", TALL, strategy="tree"),
                          {"tsqr": 1, "prep": 1, "tree.leaves": 1, "tree.level": 1,
                           "sync.tree_index": 1},
                          {"sync.tree_index": "tsqr"}),
    "tsqr_factor_cholqr2": (lambda: tq.tsqr(TALLA, "factor", TALL),
                            {"tsqr": 1, "prep": 1, "hr.round1": 1, "hr.round2": 1,
                             "hr.reconstruct": 1, "sync.guard": 1},
                            {"hr.round1": "tsqr", "hr.reconstruct": "tsqr",
                             "sync.guard": "tsqr"}),
    "qr_batched_cholqr2": (lambda: tq.qr_batched(STACK, config=tq.QRConfig(
                               batched_method="cholqr2")),
                           {"qr_batched": 1, "prep": 1, "hr.round1": 1, "hr.round2": 1,
                            "sync.guard": 1},
                           {"prep": "qr_batched", "hr.round2": "qr_batched"}),
    "qr_batched_hh": (lambda: tq.qr_batched(STACK, config=tq.QRConfig()),
                      {"qr_batched": 1, "prep": 1, "batched.geqrt": 1, "batched.form_q": 1},
                      {"prep": "qr_batched", "batched.geqrt": "qr_batched",
                       "batched.form_q": "qr_batched"}),
}


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    assert trace.span(P + "qr") is trace.span(P + "tsqr") is trace._OFF

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tq.qr(SQA, config=SQ)
    tq.tsqr(TALLA, "factor", TALL)


def test_span_records_under_a_profiler():
    def body():
        with trace.span(P + "prep"):
            return 1

    out, events = _profiled(body)
    assert out == 1 and _spans(events) == [(P + "prep", None)]


def test_spans_names_cover_every_site_once():
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(n.startswith(P) for n in trace.SPANS)
    assert set(trace.SYNCS) <= set(trace.SPANS) and set(trace.ENTRIES) <= set(trace.SPANS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_records_its_spans_with_their_nesting(case):
    call, counts, parents = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the guard stays silent on these inputs
        _, events = _profiled(call)
    seen = _spans(events)
    assert {n for n, _ in seen} <= set(trace.SPANS)
    assert collections.Counter(n for n, _ in seen) == {P + k: v for k, v in counts.items()}
    for name, parent in parents.items():
        got = {p for n, p in seen if n == P + name}
        assert got == {None if parent is None else P + parent}, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_results_are_bitwise_equal_with_and_without_the_profiler(case):
    call = CASES[case][0]
    plain, (traced, _) = call(), _profiled(call)
    a, b = _flat(plain), _flat(traced)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_tree_level_once_a_plan_level():
    a = _a(1024, 64, seed=5)
    f, events = _profiled(lambda: tsqr_driver.tsqr_factor(a, 64, ib=32, leaf_rows=128,
                                                          arity=2))
    got = collections.Counter(n for n, _ in _spans(events))
    assert len(f.plan) == 3 and got == {P + "tree.leaves": 1, P + "tree.level": 3}


def test_a_guard_trip_records_its_sync_and_falls_back():
    cfg = tq.QRConfig(nb=64, ib=32, hr_guard_tau=1e-30)
    with pytest.warns(UserWarning, match="hr guard"):
        f, events = _profiled(lambda: tq.tsqr(TALLA, "factor", cfg))
    assert isinstance(f, tq.TSQRFactors)
    got = collections.Counter(n for n, _ in _spans(events))
    assert got == {P + "tsqr": 2, P + "prep": 2, P + "hr.round1": 1, P + "hr.round2": 1,
                   P + "hr.reconstruct": 1, P + "sync.guard": 1, P + "tree.leaves": 1,
                   P + "tree.level": 1}


def test_guard_counts_a_check_on_a_well_conditioned_stack():
    _build.reset_counts()
    tq.qr_batched(SHIFTED, config=tq.QRConfig(batched_method="cholqr2"))
    assert trace.GUARD == {"qr_batched/cholqr2": {"checks": 1, "trips": 0}}
    tq.qr_batched(SHIFTED, "r", tq.QRConfig(batched_method="cholqr2", hr_guard="off"))
    assert trace.GUARD == {"qr_batched/cholqr2": {"checks": 1, "trips": 0}}  # no check made
    _build.reset_counts()
    assert trace.GUARD == {}


def test_guard_counts_a_trip_and_the_batch_falls_back_to_hh():
    """One rank-deficient member: one check, one trip, and the whole stack
    goes to the batched GEQRT, whose spans follow a second prep."""
    a = SHIFTED.clone()
    a[3, :, 1] = a[3, :, 0]
    _build.reset_counts()
    with pytest.warns(UserWarning, match="hr guard"):
        (q, r), events = _profiled(lambda: tq.qr_batched(a, config=tq.QRConfig(
            batched_method="cholqr2")))
    assert trace.GUARD == {"qr_batched/cholqr2": {"checks": 1, "trips": 1}}
    assert _build.PLAIN_CALLS["potrf_batched"] == 1 and _build.PLAIN_CALLS["geqrt_batched"] == 1
    got = collections.Counter(n for n, _ in _spans(events))
    assert got == {P + "qr_batched": 1, P + "prep": 2, P + "hr.round1": 1, P + "hr.round2": 1,
                   P + "sync.guard": 1, P + "batched.geqrt": 1, P + "batched.form_q": 1}
    hq, hr = tq.qr_batched(a, config=tq.QRConfig())
    assert torch.equal(q, hq) and torch.equal(r, hr)


# synthetic profiler events: host spans and launches, and device operations
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, device=CPU, cid=0):
    return types.SimpleNamespace(name=name, device_type=device, id=cid,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _synthetic():
    """Two calls of one entry (µs). Call 1: a panel launching op 1 and op 2
    at 20 and 40 and an update launching op 3; call 2 waits on a sync and
    launches op 4 after its panel has ended, and op 5 is launched between
    the calls. Device time lags: op 3 runs while call 2's panel is open on
    the host, which must not change where it goes."""
    return [
        _ev(P + "qr", 0, 100), _ev(P + "hh.panel", 10, 50), _ev(P + "hh.update", 50, 90),
        _ev("cudaLaunchKernel", 20, 21, cid=1), _ev("cudaLaunchKernelExC", 40, 41, cid=2),
        _ev("cudaMemcpyAsync", 60, 61, cid=3),
        _ev("cudaLaunchKernel", 105, 106, cid=5),
        _ev(P + "qr", 110, 200), _ev(P + "hh.panel", 120, 150), _ev(P + "sync.guard", 150, 190),
        _ev("cudaLaunchKernel", 195, 196, cid=4),
        _ev("aten::empty", 20, 21, cid=3),  # a host op whose id is a launch's: ignored
        _ev("panel_factor_kernel", 30, 60, CUDA, 1), _ev("panel_chain_kernel", 60, 70, CUDA, 2),
        _ev("Memcpy HtoD", 130, 140, CUDA, 3), _ev("sub_f32_kernel", 200, 204, CUDA, 4),
        _ev("other", 210, 212, CUDA, 5), _ev("lost", 220, 221, CUDA, 99),
        _ev(P + "hh.panel", 120, 150, CUDA, 0),  # a device copy of a span: not an operation
    ]


def test_span_times_charge_launch_time_innermost_and_inclusive():
    got = span_times(_synthetic())
    us = 1e-6
    assert got["exclusive"] == pytest.approx({P + "hh.panel": 40 * us,
                                              P + "hh.update": 10 * us, P + "qr": 4 * us})
    assert got["inclusive"] == pytest.approx({P + "qr": 54 * us, P + "hh.panel": 40 * us,
                                              P + "hh.update": 10 * us})
    assert got["unattributed"] == pytest.approx(3 * us)  # between calls, and no launch
    assert got["device"] == pytest.approx(57 * us)
    assert got["calls"] == 2 and got["syncs"] == 1
    assert got["host_s"] == pytest.approx(190 * us) and got["sync_s"] == pytest.approx(40 * us)


def test_kernel_times_leave_out_the_spans_device_copies():
    prof = types.SimpleNamespace(events=_synthetic)
    got = kernel_times(prof)
    assert set(got) == {"panel_factor_kernel", "panel_chain_kernel", "Memcpy HtoD",
                        "sub_f32_kernel", "other", "lost"}
    assert got["panel_factor_kernel"] == (1, pytest.approx(0.03))


def test_span_times_count_an_operation_once_a_name():
    events = [_ev(P + "tsqr", 0, 100), _ev(P + "tsqr", 10, 90), _ev(P + "tree.leaves", 20, 30),
              _ev("cudaLaunchKernel", 25, 26, cid=7), _ev("geqrt_tall_kernel", 40, 50, CUDA, 7)]
    got = span_times(events)
    assert got["inclusive"] == pytest.approx({P + "tsqr": 1e-5, P + "tree.leaves": 1e-5})
    assert got["calls"] == 1


@pytest.mark.parametrize("call,syncs", [
    (lambda: tq.tsqr(TALLA, "r", TALL, strategy="tree"), 0),
    (lambda: tq.tsqr(TALLA, "factor", TALL), 1),
    (lambda: tq.qr(SQA, config=SQ), 0),
], ids=["tree-r", "cholqr2-factor", "qr"])
def test_span_times_read_the_host_of_a_cpu_trace(call, syncs):
    _, events = _profiled(lambda: [call() for _ in range(2)])
    got = span_times(events)
    assert got["calls"] == 2 and got["syncs"] == 2 * syncs
    assert got["host_s"] > got["sync_s"] >= 0
    assert got["device"] == 0 and got["inclusive"] == {}  # no device on the CPU


def _lookahead_events():
    """One qr_factor of three panels as the hh driver runs it (µs): panel
    0, narrow 0, panel 1, rest 0, narrow 1 (the last update, one tile),
    panel 2; each update launches one chain kernel (ids 1-3, 10 µs, 20 µs,
    40 µs) and one stage-3 kernel (ids 4-6, 1 µs each)."""
    ev = [_ev(P + "qr_factor", 0, 200), _ev(P + "hh.panel", 0, 10), _ev(P + "hh.update", 10, 20),
          _ev(P + "hh.panel", 20, 30), _ev(P + "hh.update", 30, 40),
          _ev(P + "hh.update", 40, 50), _ev(P + "hh.panel", 50, 60)]
    for cid, (t, ms) in enumerate(((12, 10), (32, 20), (42, 40)), 1):
        ev += [_ev("cudaLaunchKernel", t, t + 1, cid=cid),
               _ev("chain_kernel<0, 64>", 100, 100 + ms, CUDA, cid),
               _ev("cudaLaunchKernel", t + 2, t + 3, cid=cid + 3),
               _ev("sub_f32_kernel", 200, 201, CUDA, cid + 3)]
    return ev


def test_span_times_of_one_group_and_of_the_narrow_updates():
    """``group`` counts one kernel group's operations alone;
    ``narrow_updates`` drops the rest updates' spans (an update followed by
    another update), so the narrow ones' time is what is left under
    hh.update, the rest's going to the span around it."""
    from tileqr_torch.utils.profile import group_of, narrow_updates

    us, ev = 1e-6, _lookahead_events()
    chain = group_of("chain_kernel<0, 64>")
    assert span_times(ev)["inclusive"][P + "hh.update"] == pytest.approx(73 * us)
    got = span_times(ev, chain)
    assert got["inclusive"] == pytest.approx({P + "qr_factor": 70 * us, P + "hh.update": 70 * us})
    assert got["device"] == pytest.approx(70 * us)
    kept = narrow_updates(ev)
    assert len(kept) == len(ev) - 1 and ev[4] not in kept
    narrow = span_times(kept, chain)
    assert narrow["inclusive"] == pytest.approx({P + "qr_factor": 70 * us,
                                                 P + "hh.update": 50 * us})
    assert narrow["exclusive"][P + "qr_factor"] == pytest.approx(20 * us)

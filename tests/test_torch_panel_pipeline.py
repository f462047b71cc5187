"""The pipelined K1/K2 chain (``csrc/panel_pipe.cuh``) on the CPU: its plan,
and a float64 model of its schedule.

- ``kernels/panel.py:pipeline_plan`` at every K1/K2 launch of the hh driver
  at 8192² (K1 and K2 of a panel in one launch, ``chain.panel_column``),
  of the nb = 512 tsqr chain, and of B13 and K2 on the 4×2 mesh at 16384²:
  q = nb / ib stages whose windows split R's rows, a cluster that fits one
  CTA's shared memory at the most rows a stage walks, the serial loop for
  one step, for q = 1 and inside a CUDA graph; at 8192², 31 of 32 launches
  pipelined and 160 of 192 steps overlapped.
- A float64 model of the kernel's schedule: block s of couple i runs as
  ``geqrt_in_place`` on its stage's window alone (``stage_rows``: R's rows
  of the block and every B row; the GEQRT tile and a K2 launch's first
  couple from row s·ib on), its off-diagonal T from the window's earlier
  reflectors, then its R rows into R (upper triangle); the steps run in
  pipeline order, every one that can overlap another in both orders. Every
  access is logged: the footprints of two steps the kernel can run at once
  (stage s ahead on a later couple than stage s' > s) are disjoint, and
  the model equals ``panel_factor_plain`` / ``panel_chain_plain`` to 1e-12
  (a K2 whose r_in is a full matrix too: the model is given its upper
  triangle, as ``chain.panel_chain`` gives the kernel, and the plain
  version reads no more).
- A bad geometry raises before the kernel library loads.
"""

import itertools

import numpy as np
import pytest
import torch

from tileqr_torch.drivers import sharded, square
from tileqr_torch.kernels import _build, chain, panel
from tileqr_torch.kernels.common import triu
from tileqr_torch.kernels.geqrt import geqrt_in_place
from tileqr_torch.kernels._build import SMEM_LIMIT
from tileqr_torch.kernels.geqrt import cluster_plan
from tileqr_torch.kernels.panel import pipeline_plan, stage_rows


# ---- the plan at the drivers' launches ----

def square_launches(m, n, nb, ib, chunk=4):
    """(nb, ib, steps, rows, full_first) of every launch of the hh driver's
    factor on m×n: one a panel (K1 with K2 where the panel has chunks)."""
    mt = m // nb
    c = square._chunk_for(mt, chunk)
    out = []
    for k in range(min(mt, n // nb)):
        n_head, _, nc = square._segments(k, mt, c)
        steps = 1 + n_head + nc
        rows = nb + c * nb if nc else (2 * nb if n_head else nb)
        out.append((nb, ib, steps, rows, False))
    return out


def sharded_launches(n, nb, ib, mesh=(4, 2), chunk=4):
    """The same for the sharded driver: B13 (K1 on a rank's panel column)
    and K2 (its first couple walked whole) on every mesh row."""
    pr, pc = mesh
    mt, nt, c, lmt_pad = sharded._grid(n, n, nb, pr, pc, chunk)
    out = set()
    for k in range(min(mt, nt)):
        for r in range(pr):
            _, n_head, _, nch = sharded._local_geometry(k, r, lmt_pad, pr, c)
            out.add((nb, ib, 1 + n_head, 2 * nb if n_head else nb, False))
            if nch:
                out.add((nb, ib, nch, nb + c * nb, True))
    return sorted(out)


SQUARE = square_launches(8192, 8192, 256, 128)
MAIN = sorted(set(SQUARE) | set(sharded_launches(16384, 256, 128))
              | set(square_launches(1048576, 512, 512, 128)))


def test_square_counts():
    """At 8192²: 32 launches, all but the last panel's lone GEQRT
    pipelined, 160 of their 192 couple steps overlapped."""
    plans = [pipeline_plan(*g[:4], full_first=g[4]) for g in SQUARE]
    piped = [g for g, p in zip(SQUARE, plans) if p.stages > 1]
    assert len(SQUARE) == 32 and len(piped) == 31
    assert sum(g[2] for g in SQUARE) == 192
    assert sum(g[2] - 1 for g in piped) == 160
    assert plans[-1].stages == 1 and SQUARE[-1][2] == 1


@pytest.mark.parametrize("geo", MAIN, ids=str)
def test_plan_at_the_drivers_launches(geo):
    nb, ib, steps, rows, full_first = geo
    plan = pipeline_plan(nb, ib, steps, rows, full_first)
    if steps == 1:
        assert plan.stages == 1 and plan.cluster == cluster_plan(nb, rows, ib)
        return
    q = -(-nb // ib)
    assert plan.stages == q >= 2
    # the windows split R's rows [0, nb) into the ib blocks, in order
    assert plan.windows == tuple((s * ib, min(nb, s * ib + ib)) for s in range(q))
    # the most rows any stage walks in any couple of the launch
    walks = [stage_rows(nb, ib, s, nb, rows - nb, False) for s in range(q)]
    walks += [stage_rows(nb, ib, s, 0, nb, True) for s in range(q)]
    if full_first:
        walks += [stage_rows(nb, ib, s, nb, rows - nb, True) for s in range(q)]
    assert plan.rows == max(walks)
    assert plan.cluster == cluster_plan(nb, plan.rows, ib)
    assert plan.cluster.resident and plan.cluster.smem_bytes <= SMEM_LIMIT


def test_main_path_plans():
    """The hh panel at 8192²: two stages of clusters of 16 over 128 + 1024
    rows (K2's chunks); K1 alone (B13) on 8 over 128 + 256; K2 alone on 16
    over its first couple's 1280; the tsqr chain (nb 512) four stages of
    16."""
    fused = pipeline_plan(256, 128, 11, 1280)
    assert (fused.stages, fused.rows, fused.cluster.ctas) == (2, 1152, 16)
    head = pipeline_plan(256, 128, 4, 512)
    assert (head.stages, head.rows, head.cluster.ctas) == (2, 384, 8)
    k2 = pipeline_plan(256, 128, 7, 1280, full_first=True)
    assert (k2.stages, k2.rows, k2.cluster.ctas) == (2, 1280, 16)
    tsqr_chain = pipeline_plan(512, 128, 515, 2560)
    assert (tsqr_chain.stages, tsqr_chain.rows, tsqr_chain.cluster.ctas) == (4, 2176, 16)


@pytest.mark.parametrize("nb,ib,steps", [(256, 256, 5), (256, 128, 1), (64, 128, 3), (96, 64, 1)])
def test_serial_fallback(nb, ib, steps):
    """One step or q = 1 (ib ≥ nb): the serial loop."""
    plan = pipeline_plan(nb, ib, steps, 2 * nb if steps > 1 else nb)
    assert plan.stages == 1 and plan.windows == ((0, nb),)
    assert panel._pipelined(nb, ib, steps, 2 * nb if steps > 1 else nb) is None


def test_many_stages_pipeline():
    """q has no cap: nb 64 at ib 4 runs 16 stage clusters."""
    plan = pipeline_plan(64, 4, 3, 128)
    assert plan.stages == 16 and plan.windows[-1] == (60, 64)
    assert plan.rows == stage_rows(64, 4, 0, 64, 64, False) == 68


def test_no_pipeline_inside_a_cuda_graph(monkeypatch):
    """While the stream is captured the serial loop runs: a replay of a
    pipelined launch would reuse its epoch, whose tickets are taken."""
    assert panel._pipelined(256, 128, 11, 1280) is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert panel._pipelined(256, 128, 11, 1280) is None


@pytest.mark.parametrize("args", [(0, 16, 2, 64), (64, 0, 2, 128), (64, 16, 0, 128),
                                  (64, 16, 2, 32)], ids=str)
def test_bad_geometry_raises_before_the_library(monkeypatch, args):
    def no_lib():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "lib", no_lib)
    with pytest.raises(ValueError):
        pipeline_plan(*args)
    with pytest.raises(ValueError):
        panel._pipelined(*args)


# ---- a float64 model of the pipelined schedule ----

class Mem:
    """The launch's buffers; each step's reads and writes logged as masks."""

    def __init__(self, bufs):
        self.bufs = bufs
        self.log = {}
        self.cur = None

    def at(self, step):
        self.cur = self.log.setdefault(step, {})

    def _masks(self, name):
        if name not in self.cur:
            shape = self.bufs[name].shape
            self.cur[name] = [torch.zeros(shape, dtype=torch.bool),
                              torch.zeros(shape, dtype=torch.bool)]
        return self.cur[name]

    def get(self, name, rows, cols):
        self._masks(name)[0][rows[:, None], cols[None, :]] = True
        return self.bufs[name][rows[:, None], cols[None, :]].clone()

    def put(self, name, rows, cols, val):
        self._masks(name)[1][rows[:, None], cols[None, :]] = True
        self.bufs[name][rows[:, None], cols[None, :]] = val


def ar(lo, hi):
    return torch.arange(lo, hi)


def vmask(x):
    """The window's reflectors: 1 on column c's diagonal (window row c), 0
    above, the packed value below."""
    r = torch.arange(x.shape[0])[:, None]
    c = torch.arange(x.shape[1])[None, :]
    return torch.where(r == c, 1.0, torch.where(r > c, x, 0.0)).double()


def block_step(mem, st, nb, ib, si):
    """Block si of the step's couple on its window (``PipeRows``), then its
    R rows into R, as ``panel_pipeline`` runs it."""
    s = si * ib
    ibk = min(ib, nb - s)
    r_rows, b_rows, full = st["r_rows"], st["b_rows"], st["full"]
    if full:  # the GEQRT tile or a K2 launch's first couple: every row from s on
        r_win, b_win = ar(s, max(s, r_rows)), ar(max(0, s - r_rows), b_rows)
    else:
        r_win, b_win = ar(s, s + ibk), ar(0, b_rows)
    fresh = s == 0
    cols = ar(s, nb)
    parts = []
    if len(r_win):
        parts.append(mem.get(st["r_src"] if fresh else "r", r_win, cols))
    if fresh:
        parts.append(mem.get("a", st["b_row0"] + b_win, st["col0"] + cols))
    else:
        parts.append(mem.get(st["home"], b_win, cols))
    x = torch.cat(parts)
    at = x.T.contiguous()
    tt = torch.zeros((nb - s, nb - s), dtype=torch.float64)
    geqrt_in_place(at, tt, ibk, ibk)
    x = at.T
    nr = len(r_win)
    if nr:
        mem.put("r", r_win, cols, x[:nr])
    mem.put(st["home"], b_win, cols, x[nr:])
    t = st["t"]
    blk = ar(s, s + ibk)
    tb = tt[:ibk, :ibk].T
    mem.put(t, blk, blk, tb)
    if s > 0:
        prev = ar(0, s)
        v_prev = []
        if nr:  # a TS couple's R rows of the block: zero in earlier columns
            v_prev.append(mem.get("r", r_win, prev) if full
                          else torch.zeros((nr, s), dtype=torch.float64))
        v_prev.append(mem.get(st["home"], b_win, prev))
        v_prev = torch.cat(v_prev)
        # rows of the window lie below every earlier column's diagonal
        z = v_prev.T @ vmask(x[:, :ibk])
        t1 = triu(mem.get(t, prev, prev))
        mem.put(t, prev, blk, -(t1 @ z @ tb))
        mem.put(t, blk, prev, torch.zeros((ibk, s), dtype=torch.float64))
    # R's rows of the block: the GEQRT tile's upper triangle, or with their
    # strict lower part zero
    for g in range(s, s + ibk):
        if r_rows == 0:
            row = mem.get(st["home"], ar(g, g + 1), ar(0, nb))
            mem.put("r", ar(g, g + 1), ar(0, nb), torch.where(ar(0, nb) >= g, row, 0.0))
        elif g:
            mem.put("r", ar(g, g + 1), ar(0, g), torch.zeros((1, g), dtype=torch.float64))


def launch_steps(nb, geqrt, n_head, n_chunks, block_rows, k=0, chunk_row0=0):
    """The steps of a launch (``panel_pipe.cuh``: ``pipe_couple``)."""
    steps = []
    for i in range(geqrt + n_head):
        steps.append(dict(r_rows=0 if i == 0 else nb, b_rows=nb, full=i == 0, r_src="r",
                          b_row0=(k + i) * nb, col0=k * nb, home=f"v{i}",
                          t="tg" if i == 0 else f"t{i}"))
    for c in range(n_chunks):
        i = geqrt + n_head + c
        steps.append(dict(r_rows=nb, b_rows=block_rows, full=i == 0,
                          r_src="r_in" if i == 0 else "r", b_row0=chunk_row0 + c * block_rows,
                          col0=k * nb, home=f"c{c}", t=f"u{c}"))
    return steps


def run_model(a, r_in, nb, ib, steps, order=1):
    """The steps in pipeline order (at time τ stage s runs step τ − s), the
    steps of one time in stage order (order 1) or reversed (−1)."""
    bufs = {"a": a.clone(), "r": torch.full((nb, nb), float("nan"), dtype=torch.float64)}
    if r_in is not None:
        bufs["r_in"] = r_in.clone()
    for st in steps:
        bufs[st["home"]] = torch.full((st["b_rows"], nb), float("nan"), dtype=torch.float64)
        bufs[st["t"]] = torch.zeros((nb, nb), dtype=torch.float64)
    mem = Mem(bufs)
    q = max(1, -(-nb // ib))
    for tau in range(len(steps) + q - 1):
        for si in range(q)[::order]:
            i = tau - si
            if 0 <= i < len(steps):
                mem.at((i, si))
                block_step(mem, steps[i], nb, ib, si)
    return mem


def overlapping(n_steps, q):
    """Pairs of steps the kernel can run at once: stage s on a later couple
    than stage s' > s (stage s' waits for stage s' − 1 on its own couple
    only, so stage s can be any number of couples ahead)."""
    for (i, s), (j, t) in itertools.combinations(itertools.product(range(n_steps), range(q)), 2):
        if (s < t and i > j) or (t < s and j > i):
            yield (i, s), (j, t)


def assert_disjoint(mem, n_steps, q):
    ro = {"a", "r_in"}
    for x, y in overlapping(n_steps, q):
        lx, ly = mem.log.get(x, {}), mem.log.get(y, {})
        for name in (set(lx) & set(ly)) - ro:
            (rx, wx), (ry, wy) = lx[name], ly[name]
            assert not (wx & (ry | wy)).any() and not (wy & rx).any(), (x, y, name)


def gaussian(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


GEOS = [(32, 16), (32, 8), (64, 32), (64, 16)]


@pytest.mark.parametrize("nb,ib", GEOS, ids=str)
@pytest.mark.parametrize("n_couples", [0, 1, 3])
def test_model_k1_equals_plain(nb, ib, n_couples):
    a = gaussian(((1 + n_couples) * nb, nb), nb + ib + n_couples)
    steps = launch_steps(nb, 1, n_couples, 0, 0)
    want = panel.panel_factor_plain(a, 0, nb, ib, n_couples)
    mems = [run_model(a, None, nb, ib, steps, order) for order in (1, -1)]
    for mem in mems:
        got = (mem.bufs["r"], torch.stack([mem.bufs[f"v{i}"] for i in range(1 + n_couples)]),
               mem.bufs["tg"],
               torch.stack([torch.zeros((nb, nb), dtype=torch.float64)]
                           + [mem.bufs[f"t{i}"] for i in range(1, 1 + n_couples)]))
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-12
    assert all(torch.equal(mems[0].bufs[k], mems[1].bufs[k]) for k in mems[0].bufs)
    assert_disjoint(mems[0], len(steps), -(-nb // ib))


@pytest.mark.parametrize("nb,ib", GEOS, ids=str)
@pytest.mark.parametrize("n_chunks,chunk", [(1, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("full_r_in", [False, True], ids=["triangular_r_in", "full_r_in"])
def test_model_k2_equals_plain(nb, ib, n_chunks, chunk, full_r_in):
    a = gaussian((nb + n_chunks * chunk * nb, nb), 3 * nb + ib + n_chunks)
    if full_r_in:
        r_in = gaussian((nb, nb), nb)
    else:
        r_in = panel.panel_factor_plain(a, 0, nb, ib, 0)[0]
    b = a[nb:]
    br = chunk * nb
    steps = launch_steps(nb, 0, 0, n_chunks, br)
    # the kernel is given r_in's upper triangle; the plain version reads no more
    want = chain.panel_chain_plain(b, r_in, 0, nb, 0, n_chunks, br, ib)
    mems = [run_model(b, triu(r_in), nb, ib, steps, order) for order in (1, -1)]
    for mem in mems:
        got_v = [mem.bufs[f"c{c}"] for c in range(n_chunks)]
        got_t = [mem.bufs[f"u{c}"] for c in range(n_chunks)]
        for g, w in zip([mem.bufs["r"]] + got_v + got_t,
                        [want[0]] + list(want[1]) + list(want[2])):
            assert float((g - w).abs().max()) <= 1e-12
    assert all(torch.equal(mems[0].bufs[k], mems[1].bufs[k]) for k in mems[0].bufs)
    assert_disjoint(mems[0], len(steps), -(-nb // ib))


@pytest.mark.parametrize("nb,ib", GEOS, ids=str)
@pytest.mark.parametrize("n_head,n_chunks", [(0, 1), (1, 2), (3, 1)])
def test_model_of_one_launch_a_panel_equals_plain(nb, ib, n_head, n_chunks):
    """K1 and K2 of panel column 1 in one launch (``chain.panel_column``),
    chunks of 2·nb rows, against K1 then K2 in the plain versions."""
    k, br = 1, 2 * nb
    base = (k + 1 + n_head) * nb
    a = gaussian((base + n_chunks * br, 3 * nb), nb + ib + 7 * n_head + n_chunks)
    steps = launch_steps(nb, 1, n_head, n_chunks, br, k=k, chunk_row0=base)
    k1 = panel.panel_factor_plain(a, k, nb, ib, n_head)
    k2 = chain.panel_chain_plain(a[base:], k1[0], k, nb, 0, n_chunks, br, ib)
    want = [k2[0], *k1[1], k1[2], *k1[3][1:], *k2[1], *k2[2]]
    for order in (1, -1):
        mem = run_model(a, None, nb, ib, steps, order)
        got = ([mem.bufs["r"]] + [mem.bufs[f"v{i}"] for i in range(1 + n_head)]
               + [mem.bufs["tg"]] + [mem.bufs[f"t{i}"] for i in range(1, 1 + n_head)]
               + [mem.bufs[f"c{c}"] for c in range(n_chunks)]
               + [mem.bufs[f"u{c}"] for c in range(n_chunks)])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-12
        assert_disjoint(mem, len(steps), -(-nb // ib))

"""``kernels/geqrt.py:cluster_plan``, the cluster of a K1/K2 launch, on the
CPU: for every geometry the drivers hand K1 and K2 the plan fits one CTA's
shared memory (232,448 bytes on the H100, reduction scratch included), its
C CTAs split the couple's rows with none idle, the main path's shapes keep
the active block in shared memory, and a bad geometry raises before the
kernel library is touched."""

import pytest
import torch

from tileqr_torch.drivers import sharded, square
from tileqr_torch.kernels import _build, chain, panel
from tileqr_torch.kernels._build import CLUSTER_SIZES, SMEM_LIMIT
from tileqr_torch.kernels.geqrt import (CL_XCH_FLOATS, ROWS_PER_CTA, cluster_exchange_offset,
                                        cluster_plan, cluster_smem_bytes)


def square_geometries(m, n, nb, ib, chunk=4):
    """(nb, rows, ib) of every K1 and K2 launch of the hh driver on m×n."""
    mt = m // nb
    c = square._chunk_for(mt, chunk)
    out = set()
    for k in range(min(mt, n // nb)):
        n_head, _, nc = square._segments(k, mt, c)
        out.add((nb, 2 * nb if n_head else nb, ib))
        if nc:
            out.add((nb, nb + c * nb, ib))
    return out


def sharded_geometries(n, nb, ib, mesh=(4, 2), chunk=4):
    """(nb, rows, ib) of every B13 (K1) and K2 launch of the sharded driver."""
    pr, pc = mesh
    mt, nt, c, lmt_pad = sharded._grid(n, n, nb, pr, pc, chunk)
    out = set()
    for k in range(min(mt, nt)):
        for r in range(pr):
            _, n_head, _, nch = sharded._local_geometry(k, r, lmt_pad, pr, c)
            out.add((nb, 2 * nb if n_head else nb, ib))
            if nch:
                out.add((nb, nb + c * nb, ib))
    return out


# the main path's launches: the default hh panels at 8192², B13 and K2 on
# the 4×2 mesh at 16384², the tsqr chain (the hh driver at nb = 512 on a
# 1048576×512 panel)
MAIN = sorted(square_geometries(8192, 8192, 256, 128) | sharded_geometries(16384, 256, 128)
              | square_geometries(1048576, 512, 512, 128))
# the card tests' shapes: K1 with one couple or none, K2 with couples of
# 2·nb rows (test_torch_cuda.py) and of 4·nb rows
TESTS = sorted({(nb, rows, ib) for nb, ibs in ((32, (16,)), (64, (32,)), (256, (128,)),
                                               (512, (256, 128)))
                for ib in ibs for rows in (nb, 2 * nb, 3 * nb, 5 * nb)})


def test_main_path_geometries_are_what_the_drivers_launch():
    assert (256, 512, 128) in MAIN and (256, 1280, 128) in MAIN
    assert (512, 1024, 128) in MAIN and (512, 2560, 128) in MAIN


@pytest.mark.parametrize("geo", MAIN + TESTS, ids=str)
def test_plan_fits_one_cta(geo):
    plan = cluster_plan(*geo)
    assert plan.smem_bytes == cluster_smem_bytes(*geo, plan.ctas, plan.resident)
    assert 0 < plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("geo", MAIN + TESTS, ids=str)
def test_plan_splits_the_rows_over_its_ctas(geo):
    nb, rows, ib = geo
    plan = cluster_plan(*geo)
    assert plan.ctas in CLUSTER_SIZES
    assert plan.rows_per_cta == -(-rows // plan.ctas)
    # every CTA owns rows, and no CTA owns more than the plan aims at
    # unless the cluster is already at its largest
    assert (plan.ctas - 1) * plan.rows_per_cta < rows <= plan.ctas * plan.rows_per_cta
    assert plan.rows_per_cta <= ROWS_PER_CTA or plan.ctas == CLUSTER_SIZES[-1]
    # the fewest CTAs that do: half as many would hold too many rows, or
    # not fit shared memory
    if plan.ctas > 1:
        half = plan.ctas // 2
        assert (-(-rows // half) > ROWS_PER_CTA
                or cluster_smem_bytes(nb, rows, ib, half, True) > SMEM_LIMIT)


@pytest.mark.parametrize("geo", MAIN, ids=str)
def test_main_path_is_shared_memory_resident(geo):
    assert cluster_plan(*geo).resident


def test_main_path_cluster_sizes():
    assert cluster_plan(256, 1280, 128)[:4] == (16, 197152, True, 80)  # K2
    assert cluster_plan(256, 512, 128)[:4] == (8, 188960, True, 64)    # K1 and B13
    assert cluster_plan(512, 2560, 128)[:4] == (16, 213664, True, 160)  # the nb = 512 chain


def buffer_floats(nb, rows, ib, ctas, resident):
    """The floats of a CTA's buffers, as ``geqrt_cluster.cuh:sizes`` lays
    them out: slab, Tb, work buffer (resident only), GEMM staging, both
    parities of the column partials, group partials, taus and two scalars."""
    rpc = -(-rows // ctas)
    pow2 = 1 << max(0, (ib - 1).bit_length() - 1)  # the largest power of two below ib
    ycols = max(64, pow2, -(-nb // ctas))
    big = max(rpc, ib) * (ib + 1) + ib * (ib + 1) + ib * ycols
    small = 16 * (128 + 64) + 2 * (ctas + 1) * ib + max(ib, 512) + ib + 2
    return small + (big if resident else 0)


@pytest.mark.parametrize("geo", MAIN + TESTS, ids=str)
@pytest.mark.parametrize("resident", [True, False])
def test_exchange_words_follow_the_buffers_8_byte_aligned(geo, resident):
    """The column exchange's two mbarriers and its column count sit after
    every buffer, the barriers 8-byte aligned, and the shared bytes end
    with them."""
    nb, rows, ib = geo
    for ctas in CLUSTER_SIZES:
        off = cluster_exchange_offset(nb, rows, ib, ctas, resident)
        floats = buffer_floats(nb, rows, ib, ctas, resident)
        assert off % 8 == 0 and 4 * floats <= off < 4 * floats + 8
        assert cluster_smem_bytes(nb, rows, ib, ctas, resident) == off + 4 * CL_XCH_FLOATS
        assert 2 * 8 + 4 <= 4 * CL_XCH_FLOATS


class StubLib:
    """The kernel library's C entries, each returning success without a
    launch, the workspace sizes one float: the wrappers' host side runs
    on CPU tensors as it would on the card."""

    def tq_cluster_work_floats(self, *args):
        return 1

    def __getattr__(self, name):
        if not name.startswith("tq_"):
            raise AttributeError(name)
        return lambda *args: 0


@pytest.fixture
def stub_card(monkeypatch):
    monkeypatch.setattr(_build, "is_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", StubLib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    _build.reset_counts()
    yield
    _build.reset_counts()


def test_exchange_counter_is_cleared_by_reset_counts():
    assert set(_build.EXCHANGE) == {"launches", "columns"}
    _build.count_exchange(4, 256)
    _build.count_exchange(1, 256)  # a cluster of one CTA exchanges nothing
    assert _build.EXCHANGE == {"launches": 1, "columns": 256}
    _build.reset_counts()
    assert _build.EXCHANGE == {"launches": 0, "columns": 0}


def k1_k2(nb, ib, n_head, n_chunks, chunk):
    a = torch.zeros(((1 + n_head) * nb + n_chunks * chunk * nb, nb))
    out = chain.panel_column(a, 0, nb, ib, n_head, 1 if n_chunks else 0, n_chunks, chunk * nb)
    plan = panel.pipeline_plan(nb, ib, 1 + n_head + n_chunks, nb + chunk * nb)
    return plan.cluster.ctas, (1 + n_head + n_chunks) * nb, out


def k1_serial(nb, ib):
    panel.panel_factor(torch.zeros((nb, nb)), 0, nb, ib, 0)
    return cluster_plan(nb, nb, ib).ctas, nb, None


def k2_serial(nb, ib, chunk):
    a = torch.zeros((chunk * nb, nb))
    chain.panel_chain(a, torch.zeros((nb, nb)), 0, nb, 0, 1, chunk * nb, ib)
    return cluster_plan(nb, nb + chunk * nb, ib).ctas, nb, None


def ttqrt_launch(nb, ib):
    from tileqr_torch.kernels import ttqrt

    ttqrt.ttqrt(torch.zeros((nb, nb)), torch.zeros((nb, nb)), ib)
    return ttqrt.ttqrt_plan(nb, ib).ctas, nb, None


def cluster_route(b, m, n, ib, ctas):
    from tileqr_torch.kernels import geqrt

    plan = geqrt.batched_cluster_plan_at(m, n, ib, ctas)
    geqrt._geqrt_cluster(torch.zeros((b, m, n)), plan)
    return ctas, b * n, None


# launches of the cluster routine at C = 1, 2, 4, 8, 16: K1 + K2 in one
# pipelined launch (the hh driver's panel 0 of 8192², and small ones), K1
# and K2's serial loops, TTQRT, the batched GEQRT's cluster route
EXCHANGE_CASES = {
    "panel 0 of 8192": lambda: k1_k2(256, 128, 3, 7, 4),
    "K1+K2 96/64": lambda: k1_k2(96, 64, 1, 2, 2),
    "K1+K2 32/16": lambda: k1_k2(32, 16, 1, 0, 1),
    "K1 serial 256": lambda: k1_serial(256, 128),
    "K1 serial 32": lambda: k1_serial(32, 16),
    "K2 serial 256": lambda: k2_serial(256, 128, 4),
    "ttqrt 256": lambda: ttqrt_launch(256, 128),
    "ttqrt 64": lambda: ttqrt_launch(64, 32),
    "ttqrt 32": lambda: ttqrt_launch(32, 16),
    "cluster route 32x2048x512": lambda: cluster_route(32, 2048, 512, 128, 4),
    "cluster route 2x2048x512": lambda: cluster_route(2, 2048, 512, 128, 16),
    "cluster route 1x256x256": lambda: cluster_route(1, 256, 256, 128, 8),
    "cluster route 3x128x64": lambda: cluster_route(3, 128, 64, 32, 2),
}


@pytest.mark.parametrize("case", list(EXCHANGE_CASES))
def test_exchange_counts_what_the_plan_launches(stub_card, case):
    """Each launch of the cluster routine adds one launch and the columns
    its clusters walk, taken from its plan, where C > 1; nothing at C = 1."""
    ctas, columns, _ = EXCHANGE_CASES[case]()
    want = {"launches": 1, "columns": columns} if ctas > 1 else {"launches": 0, "columns": 0}
    assert _build.EXCHANGE == want


def test_exchange_cases_cover_every_cluster_size(stub_card):
    sizes = {EXCHANGE_CASES[case]()[0] for case in EXCHANGE_CASES}
    assert sizes == set(CLUSTER_SIZES)


def test_every_panel_of_8192_exchanges():
    """The hh driver at 8192² (nb 256, ib 128, chunks of 4): each of its 32
    panels is one launch of the cluster routine at C > 1, 192 couple steps
    of 256 columns in all."""
    mt, nb, ib = 32, 256, 128
    c = square._chunk_for(mt, 4)
    launches, columns = 0, 0
    for k in range(mt):
        n_head, _, nc = square._segments(k, mt, c)
        steps = 1 + n_head + nc
        plan = panel.pipeline_plan(nb, ib, steps, nb + c * nb if nc else (2 * nb if n_head else nb))
        launches += plan.cluster.ctas > 1
        columns += steps * nb
    assert (launches, columns) == (32, 192 * nb)


@pytest.mark.parametrize("geo", [(512, 1024, 256), (512, 2560, 512), (256, 1280, 256)], ids=str)
def test_a_block_past_shared_memory_goes_to_the_workspace(geo):
    nb, rows, ib = geo
    plan = cluster_plan(*geo)
    assert not plan.resident
    assert all(cluster_smem_bytes(nb, rows, ib, c, True) > SMEM_LIMIT for c in CLUSTER_SIZES)
    assert plan.smem_bytes == cluster_smem_bytes(nb, rows, ib, plan.ctas, False)


@pytest.mark.parametrize("args", [(0, 64, 16), (64, 32, 16), (64, 128, 0)], ids=str)
def test_plan_raises_on_bad_geometry(args):
    with pytest.raises(ValueError):
        cluster_plan(*args)


def test_wrappers_raise_before_any_launch(monkeypatch):
    """On the card path (is_cuda forced true on CPU tensors) a bad geometry
    raises ValueError before the kernel library is loaded."""
    def no_lib():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_build, "is_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", no_lib)
    a = torch.zeros((256, 128))
    r = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        panel.panel_factor(a, 2, 64, 32)          # panel past the columns
    with pytest.raises(ValueError):
        panel.panel_factor(a, 0, 64, 0)           # ib < 1
    with pytest.raises(ValueError):
        chain.panel_chain(a, r, 0, 64, 1, 4, 64)  # chunks past A
    with pytest.raises(ValueError):
        chain.panel_chain(a, r, 0, 64, 0, 1, 64, 0)

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
from tileqr_torch.kernels.geqrt import ROWS_PER_CTA, cluster_plan, cluster_smem_bytes


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
    assert cluster_plan(256, 1280, 128)[:4] == (16, 197128, True, 80)  # K2
    assert cluster_plan(256, 512, 128)[:4] == (8, 188936, True, 64)    # K1 and B13
    assert cluster_plan(512, 2560, 128)[:4] == (16, 213640, True, 160)  # the nb = 512 chain


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

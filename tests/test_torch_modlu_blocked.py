"""B8's blocked LU and TTQRT's live-row cluster on the CPU: their plans and
B8's blocked order.

- ``kernels/modlu.py:modlu_plan`` and ``kernels/ttqrt.py:ttqrt_plan``, the
  clusters of the two kernels: for every geometry the drivers hand them
  (the hr square and sharded hr paths at the default nb = 256, the tsqr
  factor at nb = 512, the sharded hh tree's TTQRT at nb = 256 and TREE_IB)
  and for the card tests' shapes, the shared bytes per CTA fit one H100
  CTA (232,448 bytes) and equal the kernels' own layout; the main path's
  shapes run on a cluster with the block in shared memory; a bad geometry
  raises before the kernel library is touched. Likewise the plans of one
  fixed cluster size (``modlu_plan_at``, ``ttqrt_plan_at``), which
  ``utils/plan_sweep.py`` measures.
- A float64 model of ``csrc/modlu.cu``'s order of operations (the panels
  are the ib-column pieces of C CTAs' column slabs; each panel's column
  loop, then U12 = L11⁻¹·A12 by the rank-1 steps on the panel's rows, then
  the trailing update A22 −= L21·U12), held against tileqr's
  ``modified_lu`` in interpret mode: lu to 1e-12 (the same algebra in
  another order of additions), d exactly equal. It shows on the CPU that
  the sign choice survives blocking: each diagonal entry is fully updated
  by the time its panel reaches it.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.kernels.modlu import modified_lu as jmodified_lu
from tileqr_torch.core.config import QRConfig
from tileqr_torch.kernels import _build, modlu, ttqrt
from tileqr_torch.kernels._build import CLUSTER_SIZES, SMEM_LIMIT
from tileqr_torch.kernels.geqrt import cluster_smem_bytes
from tileqr_torch.kernels.modlu import (MODLU_COLS_PER_CTA, MODLU_IB, modlu_plan, modlu_plan_at,
                                        modlu_smem_bytes)
from tileqr_torch.kernels.ttqrt import ttqrt_plan, ttqrt_plan_at, ttqrt_rows

NB = QRConfig().nb
# B8: the hr square and sharded hr paths' panels (nb), the tsqr factor's one
# panel at BASELINE config 3 (n = 512); TTQRT: the sharded hh tree at nb
# with its TREE_IB
MODLU_MAIN = [NB, 512]
TTQRT_MAIN = [(NB, min(ttqrt.TREE_IB, NB))]
# the card tests' shapes (tests/test_torch_cuda.py) and the CPU model's
MODLU_TESTS = [8, 32, 40, 48, 64, 96, 100, 600, 1024]
TTQRT_TESTS = [(32, 16), (64, 32), (96, 64), (256, 96), (512, 256), (512, 128)]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


# ---- the plans ----

def test_main_path_geometries():
    assert MODLU_MAIN == [256, 512] and TTQRT_MAIN == [(256, 128)]


@pytest.mark.parametrize("nb", MODLU_MAIN + MODLU_TESTS)
def test_modlu_plan_fits_one_cta(nb):
    plan = modlu_plan(nb)
    cpc = -(-nb // plan.ctas)
    assert plan.ctas in CLUSTER_SIZES and plan.ib == min(MODLU_IB, cpc)
    assert plan.smem_bytes == modlu_smem_bytes(nb, plan.ctas, plan.resident)
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # every CTA holds columns, a panel never spans two CTAs' slabs
    assert (plan.ctas - 1) * cpc < nb and plan.ib <= cpc
    assert cpc <= MODLU_COLS_PER_CTA or plan.ctas == CLUSTER_SIZES[-1] or not plan.resident


@pytest.mark.parametrize("nb", MODLU_MAIN)
def test_modlu_main_path_is_a_resident_cluster(nb):
    plan = modlu_plan(nb)
    assert plan.ctas >= 2 and plan.resident
    # the whole block sits in the CTAs' slabs
    assert plan.ctas * -(-nb // plan.ctas) >= nb


def test_modlu_main_path_plans():
    assert modlu_plan(256)[:3] == (4, 16, 84096)
    assert modlu_plan(512)[:3] == (8, 16, 168064)


def test_modlu_plan_past_shared_memory_goes_to_global_memory():
    plan = modlu_plan(1024)
    assert not plan.resident and plan.ctas == 16
    assert all(modlu_smem_bytes(1024, c, True) > SMEM_LIMIT for c in CLUSTER_SIZES)


def test_modlu_panel_width_is_the_kernels():
    """MODLU_IB is csrc/modlu.cu's IB, the width its registers hold."""
    src = (Path(modlu.__file__).parents[1] / "csrc" / "modlu.cu").read_text()
    assert f"constexpr int IB = {MODLU_IB};" in src


@pytest.mark.parametrize("geo", TTQRT_MAIN + TTQRT_TESTS, ids=str)
def test_ttqrt_plan_fits_one_cta(geo):
    nb, ib = geo
    plan = ttqrt_plan(nb, ib)
    rows = ttqrt_rows(nb, ib)
    assert rows == nb + ib
    assert plan.ctas in CLUSTER_SIZES
    assert plan.smem_bytes == cluster_smem_bytes(nb, rows, ib, plan.ctas, plan.resident)
    assert 0 < plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("geo", TTQRT_MAIN, ids=str)
def test_ttqrt_main_path_is_a_resident_cluster(geo):
    plan = ttqrt_plan(*geo)
    assert plan.ctas >= 2 and plan.resident
    # its largest block's live rows, 384 of the couple's 512 at nb = 256
    assert ttqrt_rows(*geo) < 2 * geo[0]


def test_ttqrt_main_path_plan():
    assert ttqrt_plan(256, 128)[:4] == (8, 188960, True, 48)


@pytest.mark.parametrize("ctas", CLUSTER_SIZES)
def test_fixed_cluster_sizes(ctas):
    """The sweep's plan of a fixed C keeps that C, resident where its
    layout fits, and equals the wrappers' plan where they pick that C."""
    p = modlu_plan_at(256, ctas)
    assert p.ctas == ctas and p.ib == min(MODLU_IB, -(-256 // ctas))
    assert p.resident == (modlu_smem_bytes(256, ctas, True) <= SMEM_LIMIT)
    assert p.smem_bytes == modlu_smem_bytes(256, ctas, p.resident) <= SMEM_LIMIT
    t = ttqrt_plan_at(256, 128, ctas)
    assert t.ctas == ctas and t.rows_per_cta == -(-384 // ctas)
    assert t.resident == (cluster_smem_bytes(256, 384, 128, ctas, True) <= SMEM_LIMIT)
    assert t.smem_bytes == cluster_smem_bytes(256, 384, 128, ctas, t.resident) <= SMEM_LIMIT
    if ctas == modlu_plan(256).ctas:
        assert p == modlu_plan(256)
    if ctas == ttqrt_plan(256, 128).ctas:
        assert t == ttqrt_plan(256, 128)


@pytest.mark.parametrize("fn,args", [(modlu_plan, (0,)), (modlu_plan, (-1,)),
                                     (modlu_plan_at, (64, 3)), (modlu_plan_at, (0, 4))],
                         ids=lambda v: v.__name__ if callable(v) else str(v))
def test_modlu_plan_raises_on_bad_geometry(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("fn,args", [(ttqrt_plan, (0, 1)), (ttqrt_plan, (64, 0)),
                                     (ttqrt_plan, (64, 128)), (ttqrt_plan_at, (64, 32, 3))],
                         ids=lambda v: v.__name__ if callable(v) else str(v))
def test_ttqrt_plan_raises_on_bad_geometry(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_wrappers_raise_before_any_launch(monkeypatch):
    """On the card path (is_cuda forced true on CPU tensors) a bad geometry
    raises ValueError before the kernel library is loaded."""
    def no_lib():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_build, "is_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "lib", no_lib)
    with pytest.raises(ValueError):
        modlu.modified_lu(torch.zeros((64, 32)))           # not square
    with pytest.raises(ValueError):
        modlu.modified_lu(torch.zeros((0, 0)))             # no such block
    tri = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        ttqrt.ttqrt(tri, torch.zeros((32, 32)))            # tiles differ
    with pytest.raises(ValueError):
        ttqrt.ttqrt(tri, tri, ib=0)
    with pytest.raises(ValueError):
        ttqrt.ttqrt(torch.zeros((0, 0)), torch.zeros((0, 0)))


# ---- B8's blocked order, float64 ----

def blocked_modified_lu(q_top: torch.Tensor, ib: int, ctas: int):
    """csrc/modlu.cu's order on a float64 block: (lu, d)."""
    n = q_top.shape[0]
    a = q_top.clone()
    d = a.new_zeros(n)
    cpc = -(-n // ctas)
    panels = [(s, min(s + ib, (o + 1) * cpc, n))
              for o in range(ctas) for s in range(o * cpc, min(n, (o + 1) * cpc), ib)]
    for s, e in panels:
        for j in range(s, e):  # the panel's column loop, on its owner
            piv0 = float(a[j, j])
            dj = -1.0 if piv0 > 0 else 1.0
            piv = piv0 - dj
            a[j + 1:, j] /= piv
            a[j + 1:, j + 1:e] -= a[j + 1:, j:j + 1] * a[j:j + 1, j + 1:e]
            a[j, j] = piv
            d[j] = dj
        for k in range(s, e):  # U12 = L11⁻¹·A12, the rank-1 steps on the panel's rows
            a[k + 1:e, e:] -= a[k + 1:e, k:k + 1] * a[k:k + 1, e:]
        a[e:, e:] -= a[e:, s:e] @ a[s:e, e:]  # A22 −= L21·U12
    return a, d


@functools.lru_cache(maxsize=None)
def top_block(nb: int, kind: str):
    """An (nb, nb) top block of an orthonormal (4nb, nb) factor, float64;
    "flip" sets its columns' signs so that its diagonal alternates in
    sign, and with it the pivots; tileqr's (lu, d) on it in interpret mode."""
    q, _ = np.linalg.qr(np.random.default_rng(nb).standard_normal((4 * nb, nb)))
    top = q[:nb].copy()
    if kind == "flip":
        top *= np.where(np.arange(nb) % 2 == 0, 1.0, -1.0) * np.sign(np.diag(top))
    jlu, jd = jmodified_lu(jnp.asarray(top), interpret=True)
    return top, np.asarray(jlu), np.asarray(jd)


@pytest.mark.parametrize("nb", [8, 32, 48, 64])
@pytest.mark.parametrize("ib", [4, 8, 16])
@pytest.mark.parametrize("ctas", [1, 2])
@pytest.mark.parametrize("kind", ["q", "flip"])
def test_blocked_order_matches_tileqr(nb, ib, ctas, kind):
    top, jlu, jd = top_block(nb, kind)
    lu, d = blocked_modified_lu(torch.from_numpy(top), ib, ctas)
    assert rel(lu, jlu) <= 1e-12
    assert np.array_equal(d.numpy(), jd)
    if kind == "flip":
        assert {-1.0, 1.0} <= set(jd.tolist())


def test_blocked_order_on_a_zero_block():
    """Every pivot 0: d = +1 throughout and U's diagonal −1, as tileqr's."""
    lu, d = blocked_modified_lu(torch.zeros((48, 48), dtype=torch.float64), 8, 2)
    jlu, jd = jmodified_lu(jnp.zeros((48, 48), jnp.float64), interpret=True)
    assert np.array_equal(lu.numpy(), np.asarray(jlu)) and np.array_equal(d.numpy(), np.asarray(jd))
    assert torch.equal(d, torch.ones(48, dtype=torch.float64))

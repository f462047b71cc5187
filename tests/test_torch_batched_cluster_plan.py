"""The batched GEQRT's route (``tileqr_torch/kernels/geqrt.py:
batched_cluster_plan``): a stack small enough that one thread-block
cluster a matrix fits the card takes the cluster route
(``csrc/geqrt_cluster.cuh``), any other the one-block kernel. On the CPU:

- the plan at the paths' shapes: B1s (one 256² tile, C = 8), the tsqr
  tree at 1048576×512 (leaves of 512 and the first level of 128 stacks on
  the one-block kernel, levels of 32, 8, 2, 1 on C = 4, 16, 16, 16),
  ``qr_batched``'s 4096×128² (B11, B16: the one-block kernel), m < n, the
  index limit, ib past n;
- its invariants over a sweep of shapes: C a cluster size of the cluster
  routine, b·C within the card, the shared bytes the launcher's own
  layout (``cluster_smem_bytes``), within one CTA's shared memory;
- that the CPU path runs the plain version whatever the plan, and the
  plain version against tileqr's ``geqrt`` (Pallas in interpret mode) at a
  cluster-route shape: float64 ≤ 1e-12 and float32 ≤ 1e-5 relative
  Frobenius (the same algebra; fp32 sums in another order), as
  ``test_torch_batched.py`` holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.kernels import geqrt as jgeqrt
from tileqr_torch.kernels import _build, geqrt
from tileqr_torch.kernels._build import CLUSTER_SIZES, SMEM_LIMIT
from tileqr_torch.kernels.geqrt import cluster_smem_bytes

H100_SMS = 132

# (b, m, n, ib) → (ctas, ib the cluster runs, resident)
PLAN_CASES = {
    "b1s-256": ((1, 256, 256, 128), (8, 128, True)),
    "tsqr-leaves": ((512, 2048, 512, 128), (1, 128, False)),
    "tsqr-level-128": ((128, 2048, 512, 128), (1, 128, False)),
    "tsqr-level-32": ((32, 2048, 512, 128), (4, 128, False)),
    "tsqr-level-8": ((8, 2048, 512, 128), (16, 128, True)),
    "tsqr-level-2": ((2, 2048, 512, 128), (16, 128, True)),
    "tsqr-level-1": ((1, 2048, 512, 128), (16, 128, True)),
    "b11-4096x128": ((4096, 128, 128, 32), (1, 32, False)),
    "b16-4096x128": ((4096, 128, 128, 128), (1, 128, False)),
    "wide": ((1, 64, 128, 32), (1, 32, False)),
    # 16 CTAs of 65536 rows × 16 columns reach the index limit (2^20)
    "index-limit": ((1, 1048576, 16, 16), (1, 16, False)),
    "ib-past-n": ((2, 4096, 64, 128), (16, 64, True)),
    "n8-leaves": ((2, 131072, 8, 8), (16, 8, False)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=str)
def test_batched_cluster_plan_at_the_paths_shapes(case):
    (b, m, n, ib), (ctas, ibc, resident) = PLAN_CASES[case]
    plan = geqrt.batched_cluster_plan(b, m, n, ib, H100_SMS)
    assert (plan.ctas, plan.ib, plan.resident) == (ctas, ibc, resident)
    if ctas == 1:
        assert plan.smem_bytes == 0
    else:
        assert plan.smem_bytes == cluster_smem_bytes(n, m, ibc, ctas, resident)


def test_b1s_tile_plan_bytes():
    """256² at ib 128 on 8 CTAs: 32 rows a CTA, the block resident."""
    plan = geqrt.batched_cluster_plan(1, 256, 256, 128, H100_SMS)
    assert plan == (8, 128, cluster_smem_bytes(256, 256, 128, 8, True), True)
    assert -(-256 // plan.ctas) == geqrt.BATCHED_ROWS_PER_CTA


@pytest.mark.parametrize("n", [8, 64, 128, 256, 512])
@pytest.mark.parametrize("m_over_n", [1, 4, 16])
def test_batched_cluster_plan_invariants(n, m_over_n):
    m = n * m_over_n
    for b in (1, 2, 3, 8, 33, 66, 67, 132, 133, 1000):
        for ib in (8, 32, 128):
            plan = geqrt.batched_cluster_plan(b, m, n, ib, H100_SMS)
            assert plan.ctas in CLUSTER_SIZES
            assert plan.ib == (min(ib, n) if plan.ctas > 1 else ib)
            if plan.ctas > 1:
                assert b * plan.ctas <= H100_SMS
                assert 0 < plan.smem_bytes <= SMEM_LIMIT
                assert plan.smem_bytes == cluster_smem_bytes(n, m, plan.ib, plan.ctas,
                                                             plan.resident)
                assert -(-m // plan.ctas) * plan.ib < 2 ** 20
            if b > H100_SMS // 2:
                assert plan.ctas == 1  # no cluster of two fits beside the others


def test_batched_cluster_plan_follows_the_sm_count():
    """The same stack on a card of 64 SMs: 8 matrices on 8 CTAs each."""
    assert geqrt.batched_cluster_plan(8, 2048, 512, 128, 64).ctas == 8
    assert geqrt.batched_cluster_plan(8, 2048, 512, 128, 15).ctas == 1


@pytest.mark.parametrize("args", [(0, 8, 8, 8, 132), (1, 8, 8, 0, 132), (1, 8, 8, 8, 0)],
                         ids=["no-batch", "no-ib", "no-sms"])
def test_batched_cluster_plan_raises(args):
    with pytest.raises(ValueError, match="batched_cluster_plan"):
        geqrt.batched_cluster_plan(*args)


def test_the_cpu_path_runs_the_plain_version():
    """A stack the card would factor on clusters (2 × 256 × 64 at ib 32 →
    C = 8) runs the plain version on CPU tensors: one plain call, no
    launch."""
    assert geqrt.batched_cluster_plan(2, 256, 64, 32, H100_SMS).ctas > 1
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 256, 64),
                                                                  dtype=np.float32))
    _build.reset_counts()
    got = geqrt.geqrt_batched(a, 32)
    assert _build.PLAIN_CALLS["geqrt_batched"] == 1 and not any(_build.LAUNCHES.values())
    want = geqrt.geqrt_batched_plain(a, 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_plain_version_at_a_cluster_shape_matches_tileqr(dt, tol):
    """The plain version the cluster route is held to on the card, at a
    tall tile the plan sends to clusters (256 × 64 at geqrt's ib 128: C =
    8), against tileqr's single-tile GEQRT."""
    m, n = 256, 64
    assert geqrt.batched_cluster_plan(1, m, n, 128, H100_SMS).ctas == 8
    a = np.random.default_rng(1).standard_normal((m, n)).astype(dt)
    want = jgeqrt.geqrt(jnp.asarray(a), interpret=True)
    got = geqrt.geqrt(torch.tensor(a))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= tol


# ---- the four routes (batched_plan): small, cluster, tall, one-block global ----

# (b, m, n, ib) → (route, C)
ROUTE_CASES = {
    "b11-4096x128-ib32": ((4096, 128, 128, 32), ("small", 1)),
    "b16-4096x128-ib128": ((4096, 128, 128, 128), ("small", 1)),
    "tsqr-leaves": ((512, 2048, 512, 128), ("tall", 1)),
    "tsqr-level-128": ((128, 2048, 512, 128), ("tall", 1)),
    "tsqr-level-32": ((32, 2048, 512, 128), ("cluster", 4)),
    "b1s-256": ((1, 256, 256, 128), ("cluster", 8)),
    "wide-small": ((3, 32, 48, 16), ("small", 1)),
    "wide-large": ((2, 300, 400, 32), ("global", 1)),
    # both routes take it: the small route (a matrix a CTA) is picked
    "64x128-ib32": ((64, 128, 128, 32), ("small", 1)),
    "n8-leaves": ((2, 131072, 8, 8), ("cluster", 16)),
    # past the cluster route (b·C > the SMs), its 8-column panel past shared memory
    "n8-leaves-200": ((200, 131072, 8, 8), ("global", 1)),
    # past the cluster route (b·C > the SMs): the tall route
    "140x256": ((140, 256, 256, 128), ("tall", 1)),
    "4096x256": ((4096, 256, 256, 128), ("tall", 1)),
    "67x2048x512": ((67, 2048, 512, 128), ("tall", 1)),
    "wide-4096x256x512": ((4096, 256, 512, 128), ("global", 1)),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES), ids=str)
def test_batched_plan_routes(case):
    (b, m, n, ib), (route, ctas) = ROUTE_CASES[case]
    plan = geqrt.batched_plan(b, m, n, ib, H100_SMS)
    assert (plan.route, plan.ctas) == (route, ctas)
    if route == "small":
        assert plan.smem_bytes == geqrt.small_smem_bytes(m, n, ib)
        assert plan.threads == (512 if m >= n and ib >= n else 256)
    elif route == "cluster":
        assert plan[1:5] == geqrt.batched_cluster_plan(b, m, n, ib, H100_SMS)
    elif route == "tall":
        tall = geqrt.tall_plan(b, m, n, ib, H100_SMS)
        assert plan.smem_bytes == tall.smem_bytes and plan.threads == geqrt.TALL_THREADS
    else:
        assert plan.smem_bytes == 0 and plan.threads == geqrt.GLOBAL_THREADS


@pytest.mark.parametrize("n", [8, 40, 128, 159, 226])
def test_batched_plan_small_is_the_shared_memory_shapes(n):
    """The small route takes exactly the shapes whose tile, T and reflector
    fit 200 KiB (4(mn + n² + m)), whatever b and the SM count; the others
    go to the cluster route as batched_cluster_plan says, else to the tall
    route where tall_plan takes them, else to the one-block kernel."""
    for m in (1, n // 2 + 1, n, 2 * n, 8 * n):
        for b in (1, 7, 4096):
            for sms in (16, 132):
                plan = geqrt.batched_plan(b, m, n, 32, sms)
                small = 4 * (m * n + n * n + m) <= 200 * 1024
                assert (plan.route == "small") == small
                if not small:
                    c = geqrt.batched_cluster_plan(b, m, n, 32, sms).ctas
                    tall = geqrt.tall_plan(b, m, n, 32, sms) is not None
                    assert plan.route == ("cluster" if c > 1 else "tall" if tall else "global")


@pytest.mark.parametrize("args", [(0, 8, 8, 8, 132), (1, 8, 8, 0, 132), (1, 8, 8, 8, 0)],
                         ids=["no-batch", "no-ib", "no-sms"])
def test_batched_plan_raises(args):
    with pytest.raises(ValueError, match="batched_plan"):
        geqrt.batched_plan(*args)

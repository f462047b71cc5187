"""tileqr_torch's CUDA kernels on the card, against their plain versions,
both square paths (hh and hr), tsqr and qr_batched end to end, the
split-product instantiations of K3, K4, B6 and B7 in each emulated
precision mode, the whole-panel projection at 1, 2 and 3 row-block groups
(against the plain sums in the same groups), the batched GEQRT's
routes (its tall route at every width its kernel is built for), and K3's three stages and phase 2 at every tile and G
their plans can take (against the plain versions in the same groups).

Every test here needs a CUDA device and carries the ``cuda_only`` marker;
without a device the ``cuda`` fixture skips it. Run them on a machine with
an H100 (sm_90a) and nvcc:

    python -m pytest tests/test_torch_cuda.py -q

fp32 throughout (the kernels take nothing else); kernel against plain
version: relative Frobenius difference <= 1e-5 (the summation orders
differ, the algebra does not), in every precision mode against the plain
version of the same mode; and each emulated kernel nearer its own mode's
plain version than the "highest" one, which shows the split ran.
"""

import numpy as np
import pytest
import torch

import tileqr_torch
from _hh_counts import planned_hh_counts, planned_hr_counts
from tileqr_torch.kernels import _build, chain, geqrt, modlu, panel, panel_apply, potrf
from tileqr_torch.utils.verify import backward_error_f64, residuals_f64

pytestmark = pytest.mark.cuda_only
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel(x, y):
    return float(torch.linalg.norm((x - y).double()) / max(float(torch.linalg.norm(y.double())), 1e-30))


def factors(cuda, nb, seed=0):
    """A (6nb, 3nb) with its K1 (1 head couple) and K2 (2 couples of 2nb
    rows) outputs from the plain versions."""
    a = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (6 * nb, 3 * nb), dtype=np.float32)).to(cuda)
    k1 = panel.panel_factor_plain(a, 0, nb, nb // 2, 1)
    k2 = chain.panel_chain_plain(a, k1[0], 0, nb, 1, 2, 2 * nb, nb // 2)
    return a, k1, k2


@pytest.mark.parametrize("nb", [64, 256])
def test_panel_kernels_match_plain(cuda, nb):
    a, k1, k2 = factors(cuda, nb)
    got1 = panel.panel_factor(a, 0, nb, nb // 2, 1)
    got2 = chain.panel_chain(a, k1[0], 0, nb, 1, 2, 2 * nb, nb // 2)
    torch.cuda.synchronize()
    for g, w in zip(got1 + got2, k1 + k2):
        assert g.shape == w.shape and rel(g, w) <= TOL


# K1 and K2 as cluster kernels (csrc/geqrt_cluster.cuh): (nb, ib) with ib
# = nb/2 and 128 where it divides; nb = 512 at ib = 256 keeps its active
# block in the global workspace (cluster_plan: not resident)
CLUSTER_GEOS = [(32, 16), (64, 32), (256, 128), (512, 256), (512, 128)]


@pytest.mark.parametrize("nb,ib", CLUSTER_GEOS, ids=str)
@pytest.mark.parametrize("n_couples", [0, 1, 3])
def test_panel_factor_cluster_matches_plain(cuda, nb, ib, n_couples):
    a = torch.from_numpy(np.random.default_rng(nb + ib).standard_normal(
        ((1 + n_couples) * nb, nb), dtype=np.float32)).to(cuda)
    plan = geqrt.cluster_plan(nb, 2 * nb if n_couples else nb, ib)
    _build.reset_counts()
    got = panel.panel_factor(a, 0, nb, ib, n_couples)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["panel_factor"] == 1 and not any(_build.PLAIN_CALLS.values())
    want = panel.panel_factor_plain(a, 0, nb, ib, n_couples)
    errs = [rel(g, w) for g, w in zip(got, want)]
    print(f"K1 nb={nb} ib={ib} couples={n_couples} {plan}: rel {max(errs):.3e}")
    assert all(e <= TOL for e in errs)
    assert torch.equal(torch.tril(got[0], -1), torch.zeros_like(got[0]))


@pytest.mark.parametrize("nb,ib", CLUSTER_GEOS, ids=str)
@pytest.mark.parametrize("n_chunks,chunk", [(1, 1), (2, 2), (2, 4)])
def test_panel_chain_cluster_matches_plain(cuda, nb, ib, n_chunks, chunk):
    rng = np.random.default_rng(3 * nb + ib)
    a = torch.from_numpy(rng.standard_normal(
        (nb + n_chunks * chunk * nb, nb), dtype=np.float32)).to(cuda)
    r_in = panel.panel_factor_plain(a, 0, nb, ib, 0)[0]
    plan = geqrt.cluster_plan(nb, nb + chunk * nb, ib)
    _build.reset_counts()
    got = chain.panel_chain(a[nb:], r_in, 0, nb, 0, n_chunks, chunk * nb, ib)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["panel_chain"] == 1 and not any(_build.PLAIN_CALLS.values())
    want = chain.panel_chain_plain(a[nb:], r_in, 0, nb, 0, n_chunks, chunk * nb, ib)
    errs = [rel(g, w) for g, w in zip(got, want)]
    print(f"K2 nb={nb} ib={ib} chunks={n_chunks}x{chunk * nb} {plan}: rel {max(errs):.3e}")
    assert all(e <= TOL for e in errs)


def test_cluster_kernels_rerun_bitwise(cuda):
    """K1 (3 head couples) and K2 (chunk 4) at nb = 256 twice: the same bits."""
    nb = 256
    a = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (12 * nb, nb), dtype=np.float32)).to(cuda)
    k1 = [panel.panel_factor(a, 0, nb, 128, 3) for _ in range(2)]
    k2 = [chain.panel_chain(a, k1[0][0], 0, nb, 1, 2, 4 * nb, 128) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in (k1, k2):
        assert all(torch.equal(u, v) for u, v in zip(x, y))


# the pipelined chain (csrc/panel_pipe.cuh): K1 and K2 alone and a panel's
# K1 and K2 in one launch (chain.panel_column), at the cluster geometries
# (nb 512 / ib 128: four stages; 512 / 256: the global workspace) and at
# the main path's panel 0 of 8192²
PIPE_GEOS = CLUSTER_GEOS + [(96, 64)]


def pipeline_engages(nb, ib, steps, rows, full_first=False):
    plan = panel._pipelined(nb, ib, steps, rows, full_first)
    return plan is not None and plan.stages == -(-nb // ib)


@pytest.mark.parametrize("nb,ib", PIPE_GEOS, ids=str)
@pytest.mark.parametrize("n_head,n_chunks,chunk", [(0, 1, 1), (1, 2, 2), (3, 2, 4), (2, 0, 1)],
                         ids=str)
def test_panel_column_pipelined_matches_plain(cuda, nb, ib, n_head, n_chunks, chunk):
    """One launch for the panel's K1 and K2 (its chunks from the first
    chunk boundary below the head), pipelined, against K1 then K2 in the
    plain versions; the counters; bitwise reruns."""
    br, base = chunk * nb, (1 + n_head) * nb
    a = torch.from_numpy(np.random.default_rng(nb + ib + n_head).standard_normal(
        (base + n_chunks * br, nb), dtype=np.float32)).to(cuda)
    steps = 1 + n_head + n_chunks
    piped = pipeline_engages(nb, ib, steps, nb + br if n_chunks else 2 * nb)
    run = lambda: chain.panel_column(a, 0, nb, ib, n_head, base // br, n_chunks, br)  # noqa: E731
    _build.reset_counts()
    got = run()
    torch.cuda.synchronize()
    assert _build.PIPELINE == {"launches": int(piped), "overlapped_steps": (steps - 1) * piped}
    assert _build.LAUNCHES["panel_factor"] == 1 and not any(_build.PLAIN_CALLS.values())
    assert _build.LAUNCHES["panel_chain"] == int(n_chunks > 0 and not piped)
    k1 = panel.panel_factor_plain(a, 0, nb, ib, n_head)
    want = list(k1)
    if n_chunks:
        k2 = chain.panel_chain_plain(a, k1[0], 0, nb, base // br, n_chunks, br, ib)
        want = [k2[0], *k1[1:], k2[1], k2[2]]
    errs = [rel(g, w) for g, w in zip(got, want)]
    print(f"panel nb={nb} ib={ib} head={n_head} chunks={n_chunks}x{br} pipelined={piped}: "
          f"rel {max(errs):.3e}")
    assert all(e <= TOL for e in errs)
    assert torch.equal(torch.tril(got[0], -1), torch.zeros_like(got[0]))
    again = run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_pipelined_kernels_engage_and_rerun_bitwise(cuda):
    """At the main path's shapes every entry takes the pipeline: K1 with 3
    head couples (B13's launch), K2 with 7 chunks of 4·nb, panel 0 of
    8192² in one launch, the nb = 512 tsqr
    chain's four stages; reruns give the same bits; and each is within the
    kernel tolerance of the serial loop (K1 then K2, one cluster)."""
    nb, ib = 256, 128
    a = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (8192, nb), dtype=np.float32)).to(cuda)
    r_k = panel.panel_factor_plain(a, 0, nb, ib, 3)[0]
    calls = {
        "K1": lambda: panel.panel_factor(a, 0, nb, ib, 3),
        "K2": lambda: chain.panel_chain(a, r_k, 0, nb, 1, 7, 4 * nb, ib),
        "panel": lambda: chain.panel_column(a, 0, nb, ib, 3, 1, 7, 4 * nb),
    }
    for name, fn in calls.items():
        _build.reset_counts()
        x, y = fn(), fn()
        torch.cuda.synchronize()
        assert _build.PIPELINE["launches"] == 2, (name, _build.PIPELINE)
        assert all(torch.equal(u, v) for u, v in zip(x, y)), name
    want = chain.panel_chain_plain(a, r_k, 0, nb, 1, 7, 4 * nb, ib)
    got = calls["panel"]()
    assert rel(got[0], want[0]) <= TOL and rel(got[4], want[1]) <= TOL
    t = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (20 * 512, 512), dtype=np.float32)).to(cuda)
    _build.reset_counts()
    got = chain.panel_column(t, 0, 512, 128, 3, 1, 4, 2048)
    assert _build.PIPELINE == {"launches": 1, "overlapped_steps": 7}
    k1 = panel.panel_factor_plain(t, 0, 512, 128, 3)
    k2 = chain.panel_chain_plain(t, k1[0], 0, 512, 1, 4, 2048, 128)
    for g, w in zip(got, [k2[0], *k1[1:], k2[1], k2[2]]):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("nb,ib", [(256, 128), (512, 128)], ids=str)
def test_panel_chain_reads_r_ins_upper_triangle(cuda, nb, ib):
    """K2 with a full r_in at 3 chunks: the pipelined launch, the serial
    loop (one couple a launch, the R carried between them) and the plain
    version all take r_in's upper triangle, so they agree; r_in and
    triu(r_in) give the same bits."""
    rng = np.random.default_rng(nb + ib)
    n_chunks, br = 3, 2 * nb
    a = torch.from_numpy(rng.standard_normal((n_chunks * br, nb), dtype=np.float32)).to(cuda)
    r_in = torch.from_numpy(rng.standard_normal((nb, nb), dtype=np.float32)).to(cuda)
    assert pipeline_engages(nb, ib, n_chunks, nb + br, full_first=True)
    _build.reset_counts()
    piped = chain.panel_chain(a, r_in, 0, nb, 0, n_chunks, br, ib)
    again = chain.panel_chain(a, torch.triu(r_in), 0, nb, 0, n_chunks, br, ib)
    torch.cuda.synchronize()
    assert _build.PIPELINE["launches"] == 2
    assert all(torch.equal(x, y) for x, y in zip(piped, again))
    r, serial_v, serial_t = r_in, [], []
    for c in range(n_chunks):  # one couple a launch: the serial loop
        r, v, t = chain.panel_chain(a, r, 0, nb, c, 1, br, ib)
        serial_v.append(v[0])
        serial_t.append(t[0])
    assert _build.PIPELINE["launches"] == 2
    serial = (r, torch.stack(serial_v), torch.stack(serial_t))
    want = chain.panel_chain_plain(a.double(), r_in.double(), 0, nb, 0, n_chunks, br, ib)
    for got in (piped, serial):
        assert torch.equal(torch.tril(got[0], -1), torch.zeros_like(got[0]))
        errs = [rel(g, w) for g, w in zip(got, want)]
        assert all(e <= TOL for e in errs), errs
    assert all(rel(x, y) <= TOL for x, y in zip(piped, serial))


def test_pipeline_of_many_stages(cuda):
    """nb 256 at ib 16: 16 stage clusters of 16 CTAs, more CTAs than the
    card has SMs (a stage waits only on stages that took their tickets
    before it, so the launch finishes however few clusters the card holds
    at once); against the plain K1 then K2; bitwise reruns."""
    nb, ib, n_head, n_chunks, br = 256, 16, 3, 2, 4 * 256
    a = torch.from_numpy(np.random.default_rng(16).standard_normal(
        ((1 + n_head) * nb + n_chunks * br, nb), dtype=np.float32)).to(cuda)
    plan = panel.pipeline_plan(nb, ib, 1 + n_head + n_chunks, nb + br)
    assert plan.stages == 16 and plan.stages * plan.cluster.ctas > _build.sm_count(a)
    _build.reset_counts()
    got = chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)
    again = chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)
    torch.cuda.synchronize()
    assert _build.PIPELINE["launches"] == 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    k1 = panel.panel_factor_plain(a, 0, nb, ib, n_head)
    k2 = chain.panel_chain_plain(a, k1[0], 0, nb, 1, n_chunks, br, ib)
    for g, w in zip(got, [k2[0], *k1[1:], k2[1], k2[2]]):
        assert rel(g, w) <= TOL


def test_no_pipeline_inside_a_cuda_graph(cuda):
    """A panel captured in a CUDA graph runs the serial loop (a replay of a
    pipelined launch would reuse its epoch): the replays give the eager
    pipelined answer within the kernel tolerance, and the same bits each
    time; pipelined launches after the capture still run."""
    nb, ib, n_head, n_chunks, br = 256, 128, 3, 2, 4 * 256
    a = torch.from_numpy(np.random.default_rng(15).standard_normal(
        ((1 + n_head) * nb + n_chunks * br, nb), dtype=np.float32)).to(cuda)
    run = lambda: chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)  # noqa: E731
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    _build.reset_counts()
    with torch.cuda.graph(graph):
        out = run()
    assert _build.PIPELINE["launches"] == 0
    assert _build.LAUNCHES["panel_factor"] == 1 and _build.LAUNCHES["panel_chain"] == 1
    graph.replay()
    torch.cuda.synchronize()
    first = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, out))
    assert all(rel(x, y) <= TOL for x, y in zip(first, eager))
    _build.reset_counts()
    after = run()
    torch.cuda.synchronize()
    assert _build.PIPELINE["launches"] == 1
    assert all(torch.equal(x, y) for x, y in zip(after, eager))


def test_qr_pipelines_31_of_32_panels(cuda):
    """hh qr at 8192²: one K1 launch a panel, all but the last (a lone
    GEQRT) pipelined, 160 of the 192 couple steps overlapped; no K2 launch."""
    a = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (8192, 8192), dtype=np.float32)).to(cuda)
    _build.reset_counts()
    f = tileqr_torch.qr_factor(a)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["panel_factor"] == 32 and _build.LAUNCHES["panel_chain"] == 0
    assert _build.PIPELINE == {"launches": 31, "overlapped_steps": 160}
    assert _build.EXCHANGE == {"launches": 32, "columns": 192 * 256}
    r = tileqr_torch.qr(a)[1]
    assert backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r) <= 1e-6


def test_qr_at_64_panels_counts_what_its_plans_give(cuda):
    """hh qr (reduced) at 16384², 64 panels (the benchmark's
    square-16384.qr): its lookahead, pipelined launches, exchanges and K3/K4
    launches by plan are what ``planned_hh_counts`` derives from the
    driver's segments and the plans at the card's SM count, and the
    explicit-Q residual stays at the fp32 Householder level (cuSOLVER's
    ``geqrf`` + ``orgqr`` reads 1.73e-6 at this size)."""
    from tileqr_torch.core import trace

    n = 16384
    a = torch.randn((n, n), generator=torch.Generator(device="cuda").manual_seed(20),
                    device=cuda)
    _build.reset_counts()
    q, r = tileqr_torch.qr(a)
    torch.cuda.synchronize()
    want = planned_hh_counts(n, 256, 128, 4, _build.sm_count(a))
    assert trace.LOOKAHEAD == want["lookahead"]
    assert _build.PIPELINE == want["pipeline"]
    assert _build.EXCHANGE == want["exchange"]
    assert _build.STRIP == want["strip"]
    assert _build.LAUNCHES["larfb_strip"] == want["k4"]
    assert _build.LAUNCHES["panel_factor"] == n // 256 and _build.LAUNCHES["panel_chain"] == 0
    assert residuals_f64(a, q, r)["relerr"] <= 5e-6


# K3's kernels (csrc/strip.cu, csrc/panel_apply.cu's phase 2) by name
# fragment; K1/K2's names hold "chain_kernel" too, so they are taken out first
K1K2 = ("panel_factor_kernel", "panel_chain_kernel")
K3_KERNELS = ("proj_f32_kernel", "proj_wg_kernel", "chain_kernel", "sub_f32_kernel",
              "sub_wg_kernel")


def test_qr_lookahead_runs_panels_beside_the_rest(cuda):
    """hh qr_factor at 8192² (nt = 32) under torch.profiler: 30 updates
    split, panels 1-30 launched on the side stream beside a rest update,
    and at least nt - 4 of those panels' kernels overlap a K3 kernel on the
    card (any K3 kernel that overlaps panel k+1 is rest k's: narrow k+1
    waits for rest k, and rest k+1 for panel k+1); a rerun gives the same
    bits and the explicit-Q residual stays under 3e-6."""
    from tileqr_torch.core import trace

    n, nb = 8192, 256
    nt = n // nb
    a = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (n, n), dtype=np.float32)).to(cuda)
    f0 = tileqr_torch.qr_factor(a)
    torch.cuda.synchronize()
    _build.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        f1 = tileqr_torch.qr_factor(a)
        torch.cuda.synchronize()
    assert trace.LOOKAHEAD == {"split": nt - 2, "beside": nt - 2}
    ops = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    panels = sorted(o for o in ops if any(f in o[2] for f in K1K2))
    k3 = [o for o in ops if not any(f in o[2] for f in K1K2)
          and any(f in o[2] for f in K3_KERNELS)]
    assert len(panels) == nt and k3
    beside = [p for p in panels[1 : nt - 1] if any(s < p[1] and p[0] < e for s, e, _ in k3)]
    assert len(beside) >= nt - 4, (len(beside), nt - 2)
    flat = lambda f: [f.packed, f.r_diag, f.t_geqrt] + [x for p in f.panels for x in p]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(f0), flat(f1)))
    del f0, f1
    q, r = tileqr_torch.qr(a)
    assert residuals_f64(a, q, r)["relerr"] <= 3e-6


def test_qr_inside_a_cuda_graph_runs_on_one_stream(cuda):
    """qr captured in a CUDA graph splits its updates as ever but runs them
    on the one capturing stream (nothing beside), and a replay gives the
    eager answer within the kernel tolerance and the accuracy gates."""
    from tileqr_torch.core import trace

    a = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (1024, 1024), dtype=np.float32)).to(cuda)
    eager_q, eager_r = tileqr_torch.qr(a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    _build.reset_counts()
    with torch.cuda.graph(graph):
        q, r = tileqr_torch.qr(a)
    assert trace.LOOKAHEAD == {"split": 2, "beside": 0}
    graph.replay()
    torch.cuda.synchronize()
    assert rel(q, eager_q) <= TOL and rel(r, eager_r) <= TOL
    res = residuals_f64(a, q, r)
    assert res["relerr"] <= 2e-6 and res["orth"] <= 1e-4


# sha256 prefixes of the outputs of the routes that share geqrt_cluster.cuh
# with K1/K2 but are not pipelined, from the build before the pipeline on
# the card (the batched GEQRT's cluster route, TTQRT, tsqrt and K1 with one
# step run the same code paths, so the same bits)
PARENT_BITS = {"cluster 2x2048x512": "c893b6cec3ff6c0d", "cluster 1x256x256": "70149b49d33fb125",
               "ttqrt 256": "bcf527c12338416b", "tsqrt 256": "e8651fcc6a3b7a00",
               "panel_factor 1 step": "e0ad2b04ebfbd9c3"}


def test_cluster_route_and_ttqrt_keep_their_bits(cuda):
    import hashlib

    from tileqr_torch.kernels import tsqrt, ttqrt

    def bits(ts):
        d = hashlib.sha256()
        for t in ts:
            d.update(t.detach().cpu().contiguous().numpy().tobytes())
        return d.hexdigest()[:16]

    got = {}
    for b, m, n, ib in [(2, 2048, 512, 128), (1, 256, 256, 128)]:
        a = torch.from_numpy(np.random.default_rng(b + m).standard_normal(
            (b, m, n), dtype=np.float32)).to(cuda)
        got[f"cluster {b}x{m}x{n}"] = bits(geqrt.geqrt_batched(a, ib))
    rng = np.random.default_rng(256)
    r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((256, 256), dtype=np.float32)))
              .to(cuda) for _ in range(2))
    got["ttqrt 256"] = bits(ttqrt.ttqrt(r1, r2, 128))
    got["tsqrt 256"] = bits(tsqrt.tsqrt(r1, r2, 128))
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (256, 256), dtype=np.float32)).to(cuda)
    got["panel_factor 1 step"] = bits(panel.panel_factor(a, 0, 256, 128, 0))
    assert got == PARENT_BITS


# The cluster routine's column exchange (st.async into every CTA's part
# buffer, each CTA waiting on its own mbarrier; csrc/geqrt_cluster.cuh) at
# every cluster size the plans give. (nb, ib, chunk) of a panel's K1 + K2
# launch with 3 head couples and 2 chunks of chunk·nb rows, and the cluster
# size of its stages: ib 35 leaves blocks of 35, 35 and 20 columns, so the
# running column count's parity changes between blocks where jj's does not.
EXCHANGE_PIPE = [(32, 16, 1, 1), (64, 32, 2, 2), (96, 64, 2, 4), (256, 128, 1, 8),
                 (256, 128, 4, 16), (90, 35, 2, 4)]


def k1_then_k2_plain(a, nb, ib, n_head, n_chunks, br):
    k1 = panel.panel_factor_plain(a, 0, nb, ib, n_head)
    k2 = chain.panel_chain_plain(a, k1[0], 0, nb, 1, n_chunks, br, ib)
    return [k2[0], *k1[1:], k2[1], k2[2]]


@pytest.mark.parametrize("nb,ib,chunk,ctas", EXCHANGE_PIPE, ids=str)
def test_exchange_pipelined_panel_at_every_cluster_size(cuda, nb, ib, chunk, ctas):
    """The pipelined K1 + K2 launch (6 couples a stage, so the barriers'
    phases carry from couple to couple) against the plain K1 then K2;
    a rerun gives the same bits; ``EXCHANGE`` counts its columns."""
    n_head, n_chunks, br = 3, 2, chunk * nb
    a = torch.from_numpy(np.random.default_rng(nb + ib).standard_normal(
        ((1 + n_head) * nb + n_chunks * br, nb), dtype=np.float32)).to(cuda)
    plan = panel._pipelined(nb, ib, 1 + n_head + n_chunks, nb + br)
    assert plan is not None and plan.cluster.ctas == ctas
    _build.reset_counts()
    got = chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)
    again = chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)
    torch.cuda.synchronize()
    steps = 1 + n_head + n_chunks
    assert _build.EXCHANGE == ({"launches": 2, "columns": 2 * steps * nb} if ctas > 1
                               else {"launches": 0, "columns": 0})
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for g, w in zip(got, k1_then_k2_plain(a, nb, ib, n_head, n_chunks, br)):
        assert rel(g, w) <= TOL


# K2's serial loop (one couple a launch): (nb, ib, chunk, C)
EXCHANGE_K2 = [(32, 16, 1, 1), (64, 32, 1, 2), (64, 32, 3, 4), (256, 128, 1, 8),
               (256, 128, 4, 16), (90, 35, 2, 4)]


@pytest.mark.parametrize("nb,ib,chunk,ctas", EXCHANGE_K2, ids=str)
def test_exchange_k2_serial_at_every_cluster_size(cuda, nb, ib, chunk, ctas):
    rng = np.random.default_rng(7 * nb + ib)
    a = torch.from_numpy(rng.standard_normal((chunk * nb, nb), dtype=np.float32)).to(cuda)
    r_in = torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).to(cuda)
    assert geqrt.cluster_plan(nb, nb + chunk * nb, ib).ctas == ctas
    _build.reset_counts()
    got = chain.panel_chain(a, r_in, 0, nb, 0, 1, chunk * nb, ib)
    again = chain.panel_chain(a, r_in, 0, nb, 0, 1, chunk * nb, ib)
    torch.cuda.synchronize()
    assert _build.PIPELINE["launches"] == 0
    assert _build.EXCHANGE["launches"] == (2 if ctas > 1 else 0)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = chain.panel_chain_plain(a, r_in, 0, nb, 0, 1, chunk * nb, ib)
    assert all(rel(g, w) <= TOL for g, w in zip(got, want))


def test_exchange_serial_loop_over_blocks_and_couples(cuda):
    """A panel captured in a CUDA graph runs K1's and K2's serial loops:
    one cluster walks 3 blocks (35, 35, 20 columns) of each of 4 and 2
    couples, so the barriers' phases carry across blocks and couples in
    one launch; the replay matches the plain K1 then K2 and the eager
    pipelined launch, and a second replay gives the same bits."""
    nb, ib, n_head, n_chunks, br = 90, 35, 3, 2, 2 * 90
    a = torch.from_numpy(np.random.default_rng(19).standard_normal(
        ((1 + n_head) * nb + n_chunks * br, nb), dtype=np.float32)).to(cuda)
    run = lambda: chain.panel_column(a, 0, nb, ib, n_head, 1, n_chunks, br)  # noqa: E731
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    _build.reset_counts()
    with torch.cuda.graph(graph):
        out = run()
    assert _build.PIPELINE["launches"] == 0 and _build.EXCHANGE["launches"] == 2
    graph.replay()
    torch.cuda.synchronize()
    first = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, out))
    for g, e, w in zip(first, eager, k1_then_k2_plain(a, nb, ib, n_head, n_chunks, br)):
        assert rel(g, w) <= TOL and rel(g, e) <= TOL


# TTQRT (the TriRows set, dealt cyclically): (nb, ib, C)
EXCHANGE_TTQRT = [(32, 16, 1), (64, 32, 2), (96, 64, 4), (96, 35, 4), (256, 128, 8),
                  (512, 128, 16)]


@pytest.mark.parametrize("nb,ib,ctas", EXCHANGE_TTQRT, ids=str)
def test_exchange_ttqrt_at_every_cluster_size(cuda, nb, ib, ctas):
    from tileqr_torch.kernels import ttqrt

    r1, r2 = tri_pair(cuda, nb, 3 * nb + ib)
    assert ttqrt.ttqrt_plan(nb, ib).ctas == ctas
    _build.reset_counts()
    got = ttqrt.ttqrt(r1, r2, ib)
    again = ttqrt.ttqrt(r1, r2, ib)
    torch.cuda.synchronize()
    assert _build.EXCHANGE == ({"launches": 2, "columns": 2 * nb} if ctas > 1
                               else {"launches": 0, "columns": 0})
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ttqrt.ttqrt_plain(r1.cpu(), r2.cpu(), ib)
    assert all(rel(g.cpu(), w) <= TOL for g, w in zip(got, want))


# the batched GEQRT's cluster route (B clusters in one launch, every block
# of every matrix) at C = 2, 4, 8, 16 from batched_cluster_plan_at: (b, m,
# n, ib, C); ib 35 of n 100 leaves blocks of 35, 35, 30
EXCHANGE_ROUTE = [(3, 256, 100, 35, 2), (3, 256, 100, 35, 4), (2, 512, 100, 35, 8),
                  (2, 1024, 100, 35, 16), (4, 512, 256, 128, 8)]


@pytest.mark.parametrize("b,m,n,ib,ctas", EXCHANGE_ROUTE, ids=str)
def test_exchange_cluster_route_at_every_cluster_size(cuda, b, m, n, ib, ctas):
    plan = geqrt.batched_cluster_plan_at(m, n, ib, ctas)
    a = torch.from_numpy(np.random.default_rng(b * m + n).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    _build.reset_counts()
    got = geqrt._geqrt_cluster(a, plan)
    again = geqrt._geqrt_cluster(a, plan)
    torch.cuda.synchronize()
    assert _build.EXCHANGE == {"launches": 2, "columns": 2 * b * n}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = geqrt.geqrt_batched_plain(a, ib)
    assert all(rel(g, w) <= TOL for g, w in zip(got, want))


def test_exchange_launches_refuse_the_layout_without_its_words(cuda):
    """The C entries refuse shared bytes that leave out the exchange's
    words (the layout before them): the pipelined launch, TTQRT and the
    cluster route each raise, and nothing falls back."""
    from tileqr_torch.kernels import ttqrt

    short = 4 * geqrt.CL_XCH_FLOATS
    nb, ib = 256, 128
    a = torch.zeros((4 * nb, nb), device=cuda)
    plan = panel._pipelined(nb, ib, 4, 2 * nb)
    bad = plan._replace(cluster=plan.cluster._replace(
        smem_bytes=plan.cluster.smem_bytes - short))
    kw = dict(dtype=a.dtype, device=cuda)
    outs = (torch.empty((4, nb, nb), **kw), torch.empty((nb, nb), **kw),
            torch.empty((4, nb, nb), **kw))
    with pytest.raises(RuntimeError, match="panel_pipe"):
        panel.launch_pipelined(bad, a, 0, nb, ib, 1, 3, 0, 0, 0, None,
                               torch.empty((nb, nb), **kw), outs, (None, None))
    r1, r2 = tri_pair(cuda, nb)
    tp = ttqrt.ttqrt_plan(nb, ib)
    with pytest.raises(RuntimeError, match="ttqrt"):
        ttqrt._launch_ttqrt(r1, r2, ib, tp._replace(smem_bytes=tp.smem_bytes - short))
    bp = geqrt.batched_cluster_plan_at(512, 256, 128, 8)
    with pytest.raises(RuntimeError, match="cluster"):
        geqrt._geqrt_cluster(torch.zeros((2, 512, 256), device=cuda),
                             bp._replace(smem_bytes=bp.smem_bytes - short))
    torch.cuda.synchronize()


RELAUNCH_CHILD = """
import hashlib, sys
import numpy as np, torch
from tileqr_torch.kernels import chain, geqrt, ttqrt

def bits(ts):
    d = hashlib.sha256()
    for t in ts:
        d.update(t.detach().cpu().contiguous().numpy().tobytes())
    return d.hexdigest()

dev = torch.device("cuda")
rng = np.random.default_rng(21)
a = torch.from_numpy(rng.standard_normal((8192, 256), dtype=np.float32)).to(dev)
r1, r2 = (torch.from_numpy(np.triu(rng.standard_normal((256, 256), dtype=np.float32))).to(dev)
          for _ in range(2))
s = torch.from_numpy(rng.standard_normal((32, 2048, 512), dtype=np.float32)).to(dev)
r_in = torch.triu(a[:256])
plan = geqrt.batched_cluster_plan_at(2048, 512, 128, 4)
calls = {
    "panel 0 of 8192": lambda: chain.panel_column(a, 0, 256, 128, 3, 1, 7, 1024),
    "K2 serial": lambda: chain.panel_chain(a, r_in, 0, 256, 0, 1, 1024, 128),
    "ttqrt": lambda: ttqrt.ttqrt(r1, r2, 128),
    "cluster route": lambda: geqrt._geqrt_cluster(s, plan),
}
for name, fn in calls.items():
    first = bits(fn())
    for _ in range(48):
        fn()
    last = bits(fn())
    torch.cuda.synchronize()
    assert first == last, name
    print(name, "50 launches, first and last bitwise equal", flush=True)
print("ok")
"""


def test_exchange_relaunches_finish_in_time(cuda):
    """50 back-to-back launches of each of the main path's panel launch,
    K2's serial loop, TTQRT and the tree's level-2 cluster route, in a
    child process given 240 s (a wrong byte count on a barrier would hang
    rather than fail: the child is then killed, and the test fails); the
    first and the 50th outputs are bitwise equal."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _build.lib()  # built here, so the child only loads it
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    try:
        out = subprocess.run([sys.executable, "-c", RELAUNCH_CHILD], cwd=root, env=env,
                             capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        pytest.fail("the relaunches did not finish within 240 s")
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok"), out.stdout


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("trans,reverse", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cs", [0, 1])
def test_couple_strip_matches_plain(cuda, nb, trans, reverse, fused, cs):
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = factors(cuda, nb)
    larfb = dict(vkk=v_stack[0], tg=tg) if fused else {}
    outs = []
    for fn in (chain.couple_strip, chain.couple_strip_plain):
        c = a.clone()
        fn(v_chunks, t2, c, c[:nb, cs * nb:], 0, 1, 2, 2 * nb, nb, cs,
           trans=trans, reverse=reverse, **larfb)
        outs.append(c)
    torch.cuda.synchronize()
    assert rel(outs[0], outs[1]) <= TOL


@pytest.mark.parametrize("trans", [True, False])
def test_larfb_strip_matches_plain(cuda, trans):
    nb = 256
    a, (_, v_stack, tg, _), _ = factors(cuda, nb)
    s1 = a[:nb, nb:].clone()
    s2 = s1.clone()
    chain.larfb_strip(v_stack[0], tg, s1, nb, trans=trans)
    chain.larfb_strip_plain(v_stack[0], tg, s2, nb, trans=trans)
    torch.cuda.synchronize()
    assert rel(s1, s2) <= TOL


@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 700), (700, 1000)])
def test_qr_on_the_card(cuda, shape):
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape, dtype=np.float32)).to(cuda)
    _build.reset_counts()
    q, r = tileqr_torch.qr(a)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["panel_factor"] > 0 and _build.LAUNCHES["couple_strip"] > 0
    assert not any(_build.PLAIN_CALLS.values())
    res = residuals_f64(a, q, r)
    assert res["relerr"] <= 2e-6 and res["orth"] <= 1e-4
    f = tileqr_torch.qr_factor(a)
    assert backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r) <= 1e-6


def test_rerun_is_bitwise_equal(cuda):
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1024, 1024), dtype=np.float32)).to(cuda)
    f1 = tileqr_torch.qr_factor(a)
    f2 = tileqr_torch.qr_factor(a)
    flat = lambda f: [f.packed, f.r_diag, f.t_geqrt] + [x for p in f.panels for x in p]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(f1), flat(f2)))


def test_wrappers_raise_instead_of_falling_back(cuda):
    a64 = torch.zeros((128, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        panel.panel_factor(a64, 0, 64)
    a = torch.zeros((128, 128), device=cuda)
    with pytest.raises(ValueError):
        panel.panel_factor(a.T, 0, 64)  # not row-major
    with pytest.raises(ValueError):
        chain.panel_chain(a, torch.zeros((64, 64)), 0, 64, 1, 1, 64)  # mixed devices


def hr_inputs(cuda, nb, seed=3):
    """carry (5nb, 5nb) and the hr factors (Y, T) of its panel 1 column
    carry[nb:, nb:2nb], from the plain versions."""
    from tileqr_torch.drivers.square_hr import hr_panel

    carry = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (5 * nb, 5 * nb), dtype=np.float32)).to(cuda)
    y, t, _ = hr_panel(carry[nb:, nb : 2 * nb].cpu())
    return carry, y.to(cuda), t.to(cuda)


@pytest.mark.parametrize("nb", [64, 256])
def test_potrf_and_modlu_match_plain(cuda, nb):
    rng = np.random.default_rng(nb)
    x = torch.from_numpy(rng.standard_normal((4, 3 * nb, nb), dtype=np.float32)).to(cuda)
    g = x.transpose(1, 2) @ x
    for b in (1, 4):
        got = potrf.potrf_batched(g[:b])
        want = potrf.potrf_batched_plain(g[:b])
        torch.cuda.synchronize()
        assert rel(got, want) <= TOL
        assert not torch.tril(got, -1).any()
    q, _ = torch.linalg.qr(x[0].double())
    q_top = q[:nb].float()
    lu, d = modlu.modified_lu(q_top)
    lu_p, d_p = modlu.modified_lu_plain(q_top)
    torch.cuda.synchronize()
    assert rel(lu, lu_p) <= TOL and torch.equal(d, d_p)


# B9 as a blocked Cholesky on a thread-block cluster a matrix (csrc/potrf.cu),
# (B, n) at the plan's C: n = 16 on one CTA, 100 on 2 (a last block of 4
# rows), 256 on 4, 512 on 8, 768 on 16, for one matrix and for three; a
# stack of 4096 on one CTA a matrix
POTRF_CASES = [(1, 16), (3, 16), (4096, 16), (1, 100), (3, 100), (4096, 100), (1, 256),
               (3, 256), (4096, 256), (1, 512), (3, 512), (1, 768), (3, 768)]


@pytest.mark.parametrize("b,n", POTRF_CASES, ids=str)
def test_potrf_cluster_matches_plain(cuda, b, n):
    """B9 on its plan's cluster against the plain version (the same
    per-entry operations, so far inside TOL), zeros below the diagonal,
    reruns bitwise equal, one launch."""
    x = torch.from_numpy(np.random.default_rng(n + b).standard_normal(
        (b, 2 * n, n), dtype=np.float32)).to(cuda)
    g = x.transpose(1, 2) @ x
    del x
    _build.reset_counts()
    got = potrf.potrf_batched(g)
    again = potrf.potrf_batched(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["potrf_batched"] == 2 and sum(_build.LAUNCHES.values()) == 2
    assert torch.equal(got, again)
    assert not torch.tril(got, -1).any()
    assert rel(got, potrf.potrf_batched_plain(g)) <= TOL


def test_potrf_singular_gram_is_not_an_exception(cuda):
    """A singular G (zero, and rank-deficient): the clamped pivot gives huge
    or non-finite rows (or, on a zero G, zeros) where the plain version
    does, and no raise."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 40, 256), dtype=np.float32)).to(cuda)
    for g in (torch.zeros((1, 256, 256), device=cuda), x.transpose(1, 2) @ x):
        got = potrf.potrf_batched(g)
        want = potrf.potrf_batched_plain(g)
        torch.cuda.synchronize()
        broken = lambda r: bool((~torch.isfinite(r)).any() or r.abs().max() > 1e10  # noqa: E731
                                or not r.any())
        assert broken(got) and broken(want)


# B8 as a blocked LU on a thread-block cluster (csrc/modlu.cu), panels of
# 16: the plan's cluster at nb 32/40/64 (C = 1), 96/100 (2), 256 (4), 512
# (8), 600 (16, more rows than threads) and 1024 (16, the block in global
# memory); ragged last panels at nb 40 (16 + 16 + 8), 100 (CTAs of 50
# columns) and 600 (38, the last CTA 30)
MODLU_CASES = [32, 40, 64, 96, 100, 256, 512, 600, 1024]


def q_top_of(nb, kind, seed):
    """An (nb, nb) top block: of an orthonormal (4nb, nb) Q ("q"), zero
    ("zero"), or a Q's block with its columns' signs set so that the
    diagonal alternates in sign ("flip": pivots of both signs)."""
    if kind == "zero":
        return torch.zeros((nb, nb))
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((4 * nb, nb)))
    top = q[:nb].copy()
    if kind == "flip":
        top *= np.where(np.arange(nb) % 2 == 0, 1.0, -1.0) * np.sign(np.diag(top))
    return torch.from_numpy(top.astype(np.float32))


@pytest.mark.parametrize("nb", MODLU_CASES)
@pytest.mark.parametrize("kind", ["q", "zero", "flip"])
def test_modified_lu_cluster_matches_plain(cuda, nb, kind):
    q_top = q_top_of(nb, kind, nb + 7)
    plan = modlu.modlu_plan(nb)
    _build.reset_counts()
    lu, d = modlu.modified_lu(q_top.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["modified_lu"] == 1 and not any(_build.PLAIN_CALLS.values())
    lu_p, d_p = modlu.modified_lu_plain(q_top)
    err = rel(lu.cpu(), lu_p)
    print(f"B8 nb={nb} {kind} {plan}: rel {err:.3e}")
    assert err <= TOL and torch.equal(d.cpu(), d_p)
    if kind == "zero":
        assert torch.equal(d_p, torch.ones(nb))
    if kind == "flip":
        assert {-1.0, 1.0} <= set(d_p.tolist())


def test_modified_lu_wrapper_takes_the_plan(cuda):
    """The wrapper launches at modlu_plan(nb): C >= 2 and resident at nb =
    256 and 512, the same bits as the launcher at ``modlu_plan_at`` of that
    C, and reruns bitwise."""
    for nb in (256, 512):
        plan = modlu.modlu_plan(nb)
        assert plan.ctas >= 2 and plan.resident
        q_top = q_top_of(nb, "q", nb).to(cuda)
        runs = ([modlu.modified_lu(q_top) for _ in range(2)]
                + [modlu._launch_modlu(q_top, modlu.modlu_plan_at(nb, plan.ctas))])
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for run in runs[1:] for x, y in zip(run, runs[0]))


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_carry_matches_plain(cuda, nb, trans):
    carry, y, t = hr_inputs(cuda, nb)
    outs = []
    for fn in (panel_apply.panel_apply_carry, panel_apply.panel_apply_carry,
               panel_apply.panel_apply_carry_plain):
        c = carry.clone()
        fn(y, t, c, 1, nb, trans=trans)
        outs.append(c)
    torch.cuda.synchronize()
    got, again, want = outs
    assert torch.equal(got, again)  # reruns are bitwise equal
    assert torch.equal(got[:nb], carry[:nb]) and torch.equal(got[:, : 2 * nb], carry[:, : 2 * nb])
    assert rel(got, want) <= TOL


def test_hr_qr_on_the_card(cuda):
    a = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2048, 2048), dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    _build.reset_counts()
    q, r = tileqr_torch.qr(a, config=cfg)
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[k] > 0 for k in _build.HR_KERNELS + _build.APPLY_KERNELS)
    assert not any(_build.LAUNCHES[k] for k in _build.HH_KERNELS)
    assert not any(_build.PLAIN_CALLS.values())
    res = residuals_f64(a, q, r)
    assert res["relerr"] <= 3e-6 and res["orth"] <= 1e-3
    f = tileqr_torch.qr_factor(a, cfg)
    assert isinstance(f, tileqr_torch.HRFactors) and float(f.health) <= cfg.hr_guard_tau
    assert backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), r) <= 1e-6


def test_hr_guard_falls_back_to_hh_kernels(cuda):
    """A breakdown input: the hr kernels run on the panels, the guard trips
    and warns, and the hh kernels refactor."""
    b = np.random.default_rng(5).standard_normal((1024, 768)).astype(np.float32)
    b[:, 1] = b[:, 0] * (1 + 1e-7)  # panel-0 gram numerically singular
    a = torch.from_numpy(b).to(cuda)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    _build.reset_counts()
    with pytest.warns(UserWarning, match="hr guard"):
        q, r = tileqr_torch.qr(a, config=cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["modified_lu"] > 0 and _build.LAUNCHES["panel_factor"] > 0
    assert _build.LAUNCHES["panel_chain"] + _build.LAUNCHES["couple_strip"] > 0
    assert residuals_f64(a, q, r)["relerr"] <= 3e-6


def test_hr_pins_ieee_fp32_and_numpy_input_runs_on_the_card(cuda):
    """With the caller's TF32 switch on, the hr driver's matmuls still run
    in IEEE fp32 (a TF32 residual would be near 1e-3) and the switch is
    restored; a numpy input with no device= runs on the card."""
    a = np.random.default_rng(6).standard_normal((1024, 1024)).astype(np.float32)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _build.reset_counts()
        q, r = tileqr_torch.qr(a, config=cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert q.device.type == "cuda" and r.device.type == "cuda"
    assert all(_build.LAUNCHES[k] > 0 for k in _build.HR_KERNELS)
    assert residuals_f64(torch.from_numpy(a).to(cuda), q, r)["relerr"] <= 3e-6


def test_hr_qr_on_the_hr_cells_input(cuda):
    """hr qr (reduced) at 4096² on the benchmark's input of prescribed
    condition 1e2 (the square-16384-hr cell's distribution): B9, B8, B6 and
    B7 launched as ``planned_hr_counts`` gives (B7 on the 12 windows wider
    than 1024 columns), the applies' routes likewise, nothing plain, one
    guard check and no trip, a rerun bitwise equal, and the judged numbers
    (float64, against the benchmark's reference) inside the cell's limits."""
    from qrbench import spec
    from qrbench.calls import qr_reduced
    from qrbench.judge import verdict
    from qrbench.reference import householder
    from tileqr_torch.core import trace

    n = 4096
    cell = spec.cell("square-16384-hr.qr")
    g = torch.Generator(device="cuda").manual_seed(22)
    a = cell.inputs.make((n, n), torch.float32, g, "cuda", **{
        k: v for k, v in cell.config["input"].items() if k != "distribution"})
    cfg = tileqr_torch.QRConfig(**cell.config["qrconfig"])
    _build.reset_counts()
    q, r = tileqr_torch.qr(a, config=cfg)
    torch.cuda.synchronize()
    want = planned_hr_counts(n, n, cfg.nb)
    assert want["hr_apply"]["b7"] == 12
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want["launches"]
    assert trace.HR_APPLY == want["hr_apply"]
    assert not any(_build.PLAIN_CALLS.values())
    assert trace.GUARD == {"qr_factor/hr": {"checks": 1, "trips": 0}}
    q2, r2 = tileqr_torch.qr(a, config=cfg)
    assert torch.equal(q, q2) and torch.equal(r, r2)
    got = qr_reduced.numbers(a, (q, r), qr_reduced.truth(householder, a))
    checks = verdict(got, cell.limits)
    assert all(ch["ok"] for ch in checks.values()), checks


def _hr_graph_input(cuda, n=2048, seed=23):
    g = np.random.default_rng(seed).standard_normal((n, n), dtype=np.float32)
    return torch.from_numpy(g + np.float32(4 * np.sqrt(n)) * np.eye(n, dtype=np.float32)).to(cuda)


@pytest.mark.parametrize("n", [2048, 9216])
def test_hr_loop_replays_its_cuda_graphs(cuda, n):
    """The hr panel loop at one shape: the first call eager, the second
    captures the loop's graphs and replays them, the third replays; all
    three bitwise equal, each counting the planned launches and fp32
    phase-1 schedules (at 9216², B6 on panels 0 and 1, 140 and 136 tiles,
    runs the balanced schedule inside the graphs, its ticket and flags
    zeroed by the captured memset; B7 on Q's first three windows, eagerly),
    and a replay under torch.profiler records each
    phase's span once a panel with the device time of its kernels inside.
    Another shape drops the graphs and runs eagerly first again;
    ``release_graphs`` drops them too."""
    from tileqr_torch.core import trace
    from tileqr_torch.drivers import square_hr
    from tileqr_torch.utils.profile import span_times

    nb = 256
    a = _hr_graph_input(cuda, n)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    want = planned_hr_counts(n, n, nb, sms=_build.sm_count(a))
    if n == 9216 and _build.sm_count(a) == 132:
        assert want["project"] == {"balanced": 5, "whole_tiles": 62, "handed": 540}
    tileqr_torch.release_graphs()
    outs = []
    for _ in range(3):
        _build.reset_counts()
        outs.append(tileqr_torch.qr(a, config=cfg))
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want["launches"]
        assert _build.PROJECT == want["project"]
        assert trace.HR_APPLY == want["hr_apply"] and not any(_build.PLAIN_CALLS.values())
    (loop,) = square_hr._LOOPS.values()
    assert isinstance(loop, square_hr._LoopGraphs) and len(loop.panels) == n // nb
    assert not loop.lock.locked()
    for q, r in outs[1:]:
        assert torch.equal(q, outs[0][0]) and torch.equal(r, outs[0][1])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        q, r = tileqr_torch.qr(a, config=cfg)
        torch.cuda.synchronize()
    assert torch.equal(q, outs[0][0])
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("tileqr_torch.hr.")]
    panels = n // nb
    assert {k: names.count(f"tileqr_torch.hr.{k}") for k in
            ("round1", "round2", "reconstruct", "update", "apply")} == {
        "round1": panels, "round2": panels, "reconstruct": panels, "update": panels - 1,
        "apply": panels}
    inside = span_times(prof.events())["inclusive"]
    assert all(inside.get(f"tileqr_torch.hr.{k}", 0) > 0 for k in ("round1", "update", "apply"))
    tileqr_torch.qr(a[:1024, :1024].contiguous(), config=cfg)
    assert all(v is None for v in square_hr._LOOPS.values())
    q, r = tileqr_torch.qr(a, config=cfg)
    assert torch.equal(q, outs[0][0]) and torch.equal(r, outs[0][1])
    tileqr_torch.qr(a, config=cfg)
    assert isinstance(next(iter(square_hr._LOOPS.values())), square_hr._LoopGraphs)
    tileqr_torch.release_graphs()
    assert not square_hr._LOOPS


@pytest.mark.parametrize("fault", ["sync", "oom"])
def test_hr_loop_runs_eagerly_where_its_capture_fails(cuda, monkeypatch, fault):
    """A capture that fails (a host sync inside it, which the card refuses
    and which invalidates the capture; or an out-of-memory error at panel
    3) is ended, its graphs dropped, and the call runs eagerly with the
    same bits; the shape stays eager, with no capture left open, until
    ``release_graphs``, after which its second call captures again."""
    from tileqr_torch.drivers import square_hr

    a = _hr_graph_input(cuda)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    tileqr_torch.release_graphs()
    q0, r0 = tileqr_torch.qr(a, config=cfg)
    apply_carry = square_hr.panel_apply_carry

    def faulty(y, t, ap, k, nb, **kw):
        if torch.cuda.is_current_stream_capturing():
            if fault == "sync":
                y.sum().item()
            elif k == 3:
                raise torch.cuda.OutOfMemoryError("out of memory")
        return apply_carry(y, t, ap, k, nb, **kw)

    monkeypatch.setattr(square_hr, "panel_apply_carry", faulty)
    for _ in range(2):
        q, r = tileqr_torch.qr(a, config=cfg)
        torch.cuda.synchronize()
        assert not torch.cuda.is_current_stream_capturing()
        assert list(square_hr._LOOPS.values()) == [square_hr._EAGER]
        assert torch.equal(q, q0) and torch.equal(r, r0)
    monkeypatch.setattr(square_hr, "panel_apply_carry", apply_carry)
    tileqr_torch.release_graphs()
    for _ in range(2):
        q, r = tileqr_torch.qr(a, config=cfg)
    assert isinstance(next(iter(square_hr._LOOPS.values())), square_hr._LoopGraphs)
    assert torch.equal(q, q0) and torch.equal(r, r0)
    tileqr_torch.release_graphs()


def test_hr_loops_never_share_the_graphs_operands(cuda):
    """A loop that finds the graphs in use (another loop of the shape
    stopped at its first panel) runs eagerly; a loop dropped half way
    frees them. Two loops on two streams, with no host sync between
    (hr_guard="off"), each on its own input: the second's replay waits on
    the first's, and both answers are bitwise the eager ones."""
    from tileqr_torch.drivers import square_hr

    n, nb = 2048, 256
    a, b = _hr_graph_input(cuda, n, 23), _hr_graph_input(cuda, n, 24)
    cfg = tileqr_torch.QRConfig(square_method="hr", hr_guard="off")
    tileqr_torch.release_graphs()
    want_a = tileqr_torch.qr(a, config=cfg)
    want_b = tileqr_torch.qr(b, config=cfg)
    (loop,) = square_hr._LOOPS.values()
    assert isinstance(loop, square_hr._LoopGraphs)
    held = square_hr.hr_steps(square_hr.pad_for_hr(a, nb)[0], nb)
    next(held)
    assert loop.lock.locked()
    q, r = tileqr_torch.qr(b, config=cfg)
    assert torch.equal(q, want_b[0]) and torch.equal(r, want_b[1])
    del held
    assert not loop.lock.locked()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for _ in range(3):
        s1.wait_stream(torch.cuda.current_stream())
        s2.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s1):
            got_a = tileqr_torch.qr(a, config=cfg)
        with torch.cuda.stream(s2):
            got_b = tileqr_torch.qr(b, config=cfg)
        torch.cuda.synchronize()
        assert torch.equal(got_a[0], want_a[0]) and torch.equal(got_a[1], want_a[1])
        assert torch.equal(got_b[0], want_b[0]) and torch.equal(got_b[1], want_b[1])
    tileqr_torch.release_graphs()


# (B, m, n, ib): the small route (a CTA a matrix, 4(mn + n² + m) <= 200
# KiB: odd B, m < n, n not a multiple of ib, a last block narrower than ib,
# two lanes a reflector index at ib 64, a matrix wider than ib = 128), the
# cluster route (a tall leaf, a 256² tile, n = 8 leaves of 131072 rows),
# the tall route past the cluster route's b·C <= SMs (67 leaves of the
# tsqr leaves' 2048 × 512, 140 tiles of 256²) and the one-block kernel
# (m < n past the small route); each launch counted under its route's key
GEQRT_CASES = [(64, 128, 128, 32), (16, 128, 128, 128), (5, 72, 40, 32), (3, 32, 48, 16),
               (7, 100, 100, 32), (3, 100, 60, 64), (5, 159, 159, 128), (3, 40, 200, 16),
               (3, 300, 64, 32), (3, 2048, 64, 64), (2, 256, 256, 128), (2, 131072, 8, 8),
               (67, 2048, 512, 128), (140, 256, 256, 128), (2, 300, 400, 32)]


@pytest.mark.parametrize("b,m,n,ib", GEQRT_CASES,
                         ids=[f"{b}x{m}x{n}-ib{ib}" for b, m, n, ib in GEQRT_CASES])
def test_geqrt_batched_matches_plain(cuda, b, m, n, ib):
    a = torch.from_numpy(np.random.default_rng(m + n).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    before = a.clone()
    key = geqrt.ROUTE_KEYS[geqrt.batched_plan(b, m, n, ib, _build.sm_count(a)).route]
    _build.reset_counts()
    got = geqrt.geqrt_batched(a, ib)
    again = geqrt.geqrt_batched(a, ib)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == 2 and sum(_build.LAUNCHES.values()) == 2
    want = geqrt.geqrt_batched_plain(a, ib)
    assert torch.equal(a, before)  # the input is read only
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, h)  # reruns are bitwise equal
        assert g.shape == w.shape and rel(g, w) <= TOL


@pytest.mark.parametrize("b,m,n,ib", [(64, 128, 128, 32), (16, 128, 128, 128), (7, 100, 100, 32)],
                         ids=str)
def test_geqrt_small_t_blocks_are_the_recurrence(cuda, b, m, n, ib):
    """The small route's diagonal T blocks against ``t_from_gram`` of its own
    reflectors (the same recurrence, the gram in float64): only the rounding
    of G and of the recurrence differ."""
    a = torch.from_numpy(np.random.default_rng(b + m).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    assert geqrt.batched_plan(b, m, n, ib, _build.sm_count(a)).route == "small"
    packed, t = geqrt.geqrt_batched(a, ib)
    v = (torch.tril(packed, -1) + torch.eye(m, n, device=cuda)).double()
    for s in range(0, min(m, n), ib):
        e = min(s + ib, m, n)
        vb = v[:, :, s:e]
        tau = torch.diagonal(t[:, s:e, s:e], dim1=1, dim2=2).double()
        want = geqrt.t_from_gram(vb.transpose(1, 2) @ vb, tau)
        assert rel(t[:, s:e, s:e], want) <= TOL


def tall_plans(b, m, n, ib, sms):
    """Every plan the tall route's kernel is built for at this shape: each
    width whose panel fits."""
    plans = (geqrt.tall_plan_at(b, m, n, ib, sms, w) for w in geqrt.TALL_WIDTHS)
    return [p for p in plans if p is not None]


# (B, m, n, ib) through the direct entry: the leaves' shape at a small B, an
# odd B, a ragged n (a last block and panel narrower than ib and w, the
# 4-float copies) and a tall n = 8 leaf
TALL_CASES = [(3, 2048, 512, 128), (5, 256, 256, 128), (3, 200, 44, 32), (4, 130, 37, 16),
              (2, 2048, 8, 8)]


@pytest.mark.parametrize("b,m,n,ib", TALL_CASES, ids=[f"{b}x{m}x{n}-ib{ib}" for b, m, n, ib in TALL_CASES])
def test_geqrt_tall_at_every_width(cuda, b, m, n, ib):
    """The tall route at every width and leaves an SM its kernel is built
    for, against the plain version; reruns bitwise, the input read only,
    one launch a call under its key."""
    a = torch.from_numpy(np.random.default_rng(b + m + n).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    before = a.clone()
    want = geqrt.geqrt_batched_plain(a, ib)
    plans = tall_plans(b, m, n, ib, _build.sm_count(a))
    assert geqrt.tall_plan(b, m, n, ib, _build.sm_count(a)) in plans
    for plan in plans:
        _build.reset_counts()
        got = geqrt._geqrt_tall(a, plan)
        again = geqrt._geqrt_tall(a, plan)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["geqrt_batched[tall]"] == 2 and sum(_build.LAUNCHES.values()) == 2
        assert torch.equal(a, before)
        for g, h, w in zip(got, again, want):
            assert torch.equal(g, h)
            assert rel(g, w) <= TOL, plan


@pytest.mark.parametrize("b,m,n,ib", [(3, 2048, 512, 128), (5, 256, 256, 128), (3, 200, 44, 32)],
                         ids=str)
def test_geqrt_tall_t_is_the_recurrence(cuda, b, m, n, ib):
    """The tall route's T, each ib block and the whole matrix, against
    ``t_from_gram`` of its own reflectors (the gram in float64): the panels'
    larft and the joins build the T of the column recurrence."""
    a = torch.from_numpy(np.random.default_rng(b + n).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    packed, t = geqrt._geqrt_tall(a, geqrt.tall_plan(b, m, n, ib, _build.sm_count(a)))
    v = (torch.tril(packed, -1) + torch.eye(m, n, device=cuda)).double()
    tau = torch.diagonal(t, dim1=1, dim2=2).double()
    for s in range(0, n, ib):
        e = min(s + ib, n)
        vb = v[:, :, s:e]
        want = geqrt.t_from_gram(vb.transpose(1, 2) @ vb, tau[:, s:e])
        assert rel(t[:, s:e, s:e], want) <= TOL
    assert rel(t, geqrt.t_from_gram(v.transpose(1, 2) @ v, tau)) <= TOL
    assert not torch.tril(t, -1).any()


def test_geqrt_tall_refuses_what_it_cannot_take(cuda):
    a = torch.zeros((2, 64, 128), device=cuda)
    plan = geqrt.tall_plan(2, 128, 64, 32, _build.sm_count(a))
    with pytest.raises(ValueError, match="tall"):
        geqrt._geqrt_tall(a, plan)  # m < n
    with pytest.raises(ValueError, match="tall"):
        geqrt._geqrt_tall(a.transpose(1, 2).contiguous(), plan._replace(w=12))


def test_geqrt_batched_raises_on_float64(cuda):
    with pytest.raises(TypeError):
        geqrt.geqrt_batched(torch.zeros((2, 16, 16), dtype=torch.float64, device=cuda), 8)
    with pytest.raises(TypeError):
        tileqr_torch.qr_batched(torch.zeros((2, 16, 16), dtype=torch.float64, device=cuda),
                                config=tileqr_torch.QRConfig(dtype=torch.float64))


@pytest.mark.parametrize("m", [8192, 65536])
@pytest.mark.parametrize("strategy", ["tree", "cholqr2", "chain"])
def test_tsqr_on_the_card(cuda, strategy, m):
    """8192×64 is one leaf; 65536×64 four leaves of 16384 rows and a level."""
    a = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (m, 64), dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(nb=64)
    _build.reset_counts()
    q, r = tileqr_torch.tsqr(a, "reduced", cfg, strategy=strategy)
    torch.cuda.synchronize()
    assert not any(_build.PLAIN_CALLS.values())
    # the tree's leaves and levels take the batched GEQRT's routes
    own = {"tree": _build.TS_KERNELS, "cholqr2": ("potrf_batched",),
           "chain": ("panel_factor",)}
    assert sum(_build.LAUNCHES[k] for k in own[strategy]) > 0
    res = residuals_f64(a, q, r)
    assert res["relerr"] <= 3e-6 and res["orth"] <= 1e-4
    if strategy != "chain":
        f = tileqr_torch.tsqr(a, "factor", cfg, strategy=strategy)
        rf = f.r[:64, :64]  # the reconstruction's R carries its own signs
        assert backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True), rf) <= 1e-6


@pytest.mark.parametrize("method", ["hh", "cholqr2"])
def test_qr_batched_on_the_card(cuda, method):
    """A well-conditioned batch (G + 4·√128·I), so cholqr2 keeps its result."""
    g = np.random.default_rng(9).standard_normal((64, 128, 128), dtype=np.float32)
    a = torch.from_numpy(g + np.float32(4 * np.sqrt(128)) * np.eye(128, dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(batched_method=method)
    _build.reset_counts()
    q, r = tileqr_torch.qr_batched(a, config=cfg)
    torch.cuda.synchronize()
    assert not any(_build.PLAIN_CALLS.values())
    # 64 matrices of 128² at ib 32 take the small route (a CTA a matrix)
    gq = geqrt.ROUTE_KEYS[geqrt.batched_plan(64, 128, 128, cfg.batched_ib,
                                              _build.sm_count(a)).route]
    assert gq == "geqrt_batched[small]"
    own, other = (gq, "potrf_batched") if method == "hh" else ("potrf_batched", gq)
    assert _build.LAUNCHES[own] == 1 and _build.LAUNCHES[other] == 0
    a64, q64, r64 = a.double(), q.double(), r.double()
    res = torch.linalg.norm(a64 - q64 @ r64, dim=(1, 2)) / torch.linalg.norm(a64, dim=(1, 2))
    orth = torch.linalg.norm(q64.transpose(1, 2) @ q64 - torch.eye(128, device=cuda,
                                                                   dtype=torch.float64),
                             dim=(1, 2))
    assert float(res.max()) <= 1e-6 and float(orth.max()) <= 1e-4
    assert torch.equal(tileqr_torch.qr_batched(a, "r", cfg), r)


def test_tsqr_and_qr_batched_pin_ieee_fp32(cuda):
    """With the caller's TF32 switch on, tsqr_apply_q's and qr_batched's
    products still run in IEEE fp32: the results equal those made with TF32
    off, and the switch is restored."""
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.standard_normal((65536, 64), dtype=np.float32)).to(cuda)
    stack = torch.from_numpy(rng.standard_normal((32, 128, 128), dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(nb=64)
    f = tileqr_torch.tsqr(a, "factor", cfg, strategy="tree")

    def run():
        return (tileqr_torch.apply_q(f, a, trans=True),) + tileqr_torch.qr_batched(stack)

    off = run()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = run()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(x, y) for x, y in zip(on, off))


MODES = ["b3", "b4", "default"]
# "default" keeps no lo half: where the kernel's and the plain version's
# fp32 sums of an intermediate (W, W2) differ in the last bit, its bf16
# rounding can flip, 2^-9 relative in that entry, and the flips compound
# over chained couples: the two agree to 3e-5..4e-4 (H100), against the
# mode's own 2e-3..9e-3 from "highest"
TOL_MODE = {"b3": TOL, "b4": TOL, "default": 1e-3}


def nearer_own_mode(got, own, highest, mode):
    """The kernel agrees with its mode's plain version and is nearer it
    than the "highest" one."""
    d_own, d_hi = rel(got, own), rel(got, highest)
    assert d_own <= TOL_MODE[mode] and d_own < d_hi, (mode, d_own, d_hi)
    return True


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("trans,reverse,fused", [(True, False, True), (False, True, True),
                                                 (True, False, False)])
def test_couple_strip_modes_match_plain(cuda, nb, mode, trans, reverse, fused):
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = factors(cuda, nb)
    larfb = dict(vkk=v_stack[0], tg=tg) if fused else {}
    outs = []
    for fn, prec in ((chain.couple_strip, mode), (chain.couple_strip, mode),
                     (chain.couple_strip_plain, mode), (chain.couple_strip_plain, "highest")):
        c = a.clone()
        fn(v_chunks, t2, c, c[:nb, nb:], 0, 1, 2, 2 * nb, nb, 1, trans=trans, reverse=reverse,
           precision=prec, **larfb)
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # reruns are bitwise equal
    assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("mode", MODES)
def test_larfb_strip_modes_match_plain(cuda, nb, mode):
    a, (_, v_stack, tg, _), _ = factors(cuda, nb)
    outs = []
    for fn, prec in ((chain.larfb_strip, mode), (chain.larfb_strip_plain, mode),
                     (chain.larfb_strip_plain, "highest")):
        s = a[:nb, nb:].clone()
        fn(v_stack[0], tg, s, nb, trans=True, precision=prec)
        outs.append(s)
    torch.cuda.synchronize()
    assert nearer_own_mode(*outs, mode)


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_carry_modes_match_plain(cuda, nb, mode, trans):
    carry, y, t = hr_inputs(cuda, nb)
    outs = []
    for fn, prec in ((panel_apply.panel_apply_carry, mode), (panel_apply.panel_apply_carry, mode),
                     (panel_apply.panel_apply_carry_plain, mode),
                     (panel_apply.panel_apply_carry_plain, "highest")):
        c = carry.clone()
        fn(y, t, c, 1, nb, trans=trans, precision=prec)
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][:nb], carry[:nb]) and torch.equal(outs[0][:, : 2 * nb],
                                                                 carry[:, : 2 * nb])
    assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("mode", ["highest"] + MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_matches_plain_on_a_window(cuda, nb, mode, trans):
    """B7 on a strided window view (the orgqr window), in place."""
    carry, y, t = hr_inputs(cuda, nb)
    outs = []
    for fn, prec in ((panel_apply.panel_apply, mode), (panel_apply.panel_apply, mode),
                     (panel_apply.panel_apply_plain, mode),
                     (panel_apply.panel_apply_plain, "highest")):
        c = carry.clone()
        win = c[nb:, 2 * nb:]
        assert fn(y, t, win, trans=trans, precision=prec) is win
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][:nb], carry[:nb]) and torch.equal(outs[0][:, : 2 * nb],
                                                                 carry[:, : 2 * nb])
    if mode == "highest":
        assert rel(outs[0], outs[2]) <= TOL
    else:
        assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


@pytest.mark.parametrize("method", ["hh", "hr"])
@pytest.mark.parametrize("mode", MODES)
def test_qr_modes_on_the_card(cuda, method, mode):
    """qr at 2048² in each emulated mode: only that mode's instantiations of
    the update kernels launch, no plain version runs, the error is the
    mode's, and reruns are bitwise equal. A = G + 4·√n·I: the hr guard
    trips on a gaussian A in "b4" and "default", whose update error nears
    its small singular values."""
    g = np.random.default_rng(11).standard_normal((2048, 2048), dtype=np.float32)
    a = torch.from_numpy(g + np.float32(4 * np.sqrt(2048)) * np.eye(2048, dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(square_method=method, precision=mode)
    _build.reset_counts()
    q, r = tileqr_torch.qr(a, config=cfg)
    torch.cuda.synchronize()
    own = (["couple_strip"] if method == "hh" else ["panel_apply_carry", "panel_apply"])
    assert all(_build.LAUNCHES[f"{k}[{mode}]"] > 0 for k in own)
    ran = {k for k, v in _build.LAUNCHES.items() if v}
    allowed = ({"panel_factor", "panel_chain"} if method == "hh" else
               {"modified_lu", "potrf_batched"}) | {f"{k}[{mode}]" for k in _build.MODE_KERNELS}
    assert ran <= allowed, ran
    assert not any(_build.PLAIN_CALLS.values())
    res = residuals_f64(a, q, r)
    tol = 1e-1 if mode == "default" else 1e-4
    assert res["relerr"] <= tol and (mode == "default" or res["orth"] <= 1e-2)
    f = tileqr_torch.qr_factor(a, cfg)
    assert backward_error_f64(a, tileqr_torch.apply_q(f, a, trans=True, config=cfg), r) <= tol
    f2 = tileqr_torch.qr_factor(a, cfg)
    flat = ((lambda f: [f.packed] + [x for p in f.panels for x in p]) if method == "hh" else  # noqa: E731
            (lambda f: [f.r] + [x for p in f.panels for x in p]))
    assert all(torch.equal(x, y) for x, y in zip(flat(f), flat(f2)))


def test_high_is_b3_on_the_card(cuda):
    g = np.random.default_rng(12).standard_normal((1024, 1024), dtype=np.float32)
    a = torch.from_numpy(g + np.float32(4 * np.sqrt(1024)) * np.eye(1024, dtype=np.float32)).to(cuda)
    for method in ("hh", "hr"):
        b3 = tileqr_torch.qr(a, config=tileqr_torch.QRConfig(square_method=method,
                                                             precision="b3"))
        hi = tileqr_torch.qr(a, config=tileqr_torch.QRConfig(square_method=method,
                                                             precision="high"))
        assert all(torch.equal(x, y) for x, y in zip(b3, hi))


@pytest.mark.parametrize("mode", ["highest", "b3"])
@pytest.mark.parametrize("nb,cols", [(64, 2048), (64, 40), (512, 2048), (768, 1536), (40, 2040)])
def test_hr_apply_routes_on_the_card(cuda, mode, nb, cols):
    """The hr apply on the card: in b3 every nb-aligned target launches B7,
    whatever nb (nb = 512 is what ``tsqr(..., "factor")`` makes for n = 512;
    40 is no multiple of 32); in "highest" only targets past 1024 columns
    with an nb the fp32 B7 takes; the rest run the reference's matmul
    routes. Each result within its mode's error of the float64 product, and
    no plain version ran."""
    from tileqr_torch.drivers.square_hr import _apply_block_t

    rng = np.random.default_rng(nb + cols)
    m = nb * max(1, 4096 // nb)
    y = rng.standard_normal((m, nb)) / np.sqrt(m)
    y[:nb] = np.tril(y[:nb], -1) + np.eye(nb)
    t = np.triu(rng.standard_normal((nb, nb))) / nb
    c = rng.standard_normal((m, cols))
    want = c - y @ (t.T @ (y.T @ c))
    yc, tc = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (y, t))
    cc = torch.from_numpy(c.astype(np.float32)).to(cuda)
    _build.reset_counts()
    assert _build.LAUNCHES["panel_apply[b3]"] == 0
    assert _apply_block_t(yc, tc, cc, True, mode) is cc
    torch.cuda.synchronize()
    aligned = cols % nb == 0
    b7 = aligned and (mode != "highest" or (cols > 1024 and panel_apply.kernel_takes(nb)))
    key = "panel_apply" if mode == "highest" else f"panel_apply[{mode}]"
    assert _build.LAUNCHES[key] == int(b7) and not any(_build.PLAIN_CALLS.values())
    assert rel(cc.double(), torch.from_numpy(want).to(cuda)) <= (1e-5 if mode == "highest"
                                                                  else 1e-4)


@pytest.mark.parametrize("nb", [40, 512, 768])
@pytest.mark.parametrize("mode", MODES)
def test_split_panel_apply_takes_any_nb(cuda, nb, mode):
    """B7's split instantiations at an nb the fp32 one does not take (and
    a column count no multiple of 32 at nb = 40), against the plain version
    of the same mode, nearer it than the "highest" one; bitwise reruns."""
    rng = np.random.default_rng(nb)
    m, n = 2 * max(nb, 1024 // nb * nb), 3 * nb
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda) / m ** 0.5
    t = torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).to(cuda) / nb
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(cuda)
    outs = []
    for fn, prec in ((panel_apply.panel_apply, mode), (panel_apply.panel_apply, mode),
                     (panel_apply.panel_apply_plain, mode),
                     (panel_apply.panel_apply_plain, "highest")):
        outs.append(fn(y, t, c.clone(), trans=True, precision=prec))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


def test_panel_apply_raises_past_its_nb(cuda):
    """On the card an nb no instantiation takes raises: 776 in b3, 512 in
    "highest"; nothing falls back to the plain version."""
    for nb, mode in ((776, "b3"), (512, "highest")):
        y = torch.zeros((2 * nb, nb), device=cuda)
        t = torch.zeros((nb, nb), device=cuda)
        _build.reset_counts()
        with pytest.raises(ValueError, match="nb"):
            panel_apply.panel_apply(y, t, torch.zeros((2 * nb, nb), device=cuda), precision=mode)
        assert not any(_build.PLAIN_CALLS.values())


@pytest.mark.parametrize("passes", [0, 3])
def test_panel_project_without_t_is_the_bare_sum(cuda, passes):
    """``tq_panel_project`` with a null T returns Σᵢ Yᵢᵀ Cᵢ itself (the
    entry B7's half ``panel_project`` takes), Kahan-summed over 2 row
    blocks at G = 1 (W written directly), in "highest" and in b3."""
    nb, m, n = 64, 512, 96
    mode = {0: "highest", 3: "b3"}[passes]
    rng = np.random.default_rng(passes)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(cuda)
    plan = panel_apply.project_plan_at(m, n, nb, m // 2, 1, mode)
    assert plan.groups == 1 and plan.workspace == 0
    w = panel_apply._launch_project(y, None, c, m // 2, mode, plan)
    torch.cuda.synchronize()
    assert rel(w, y.double().T @ c.double()) <= (1e-6 if passes == 0 else 1e-5)



# (m, nb, n, mr, column offset of C in a wider matrix): 3 row blocks at nb
# 64; 6 at 256 (ragged n in the split modes: 200 = 3 column tiles of 64 and
# a part); nb 40 with mr 80 (the split kernel's 32-row stages end inside a
# row block); C at an odd column offset (not 16-byte aligned: 4-byte copies)
PROJECT_CASES = [(1536, 64, 192, 512, 32), (3072, 256, 512, 512, 32),
                 (3072, 256, 200, 512, 32), (480, 40, 120, 80, 32), (1536, 64, 192, 512, 1),
                 (480, 40, 120, 80, 3)]
# the fp32 instantiation takes nb and n multiples of 32 only
PROJECT_MODE_CASES = [(case, mode) for case in PROJECT_CASES for mode in ["highest"] + MODES
                      if mode != "highest" or (case[1] % 32 == 0 and case[2] % 32 == 0)]


@pytest.mark.parametrize("case,mode", PROJECT_MODE_CASES,
                         ids=[f"{'x'.join(map(str, c))}-{m}" for c, m in PROJECT_MODE_CASES])
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("fold", [False, True])
def test_panel_project_groups_match_plain(cuda, case, mode, groups, fold):
    """The projection kernel at G = 1, 2, 3 on a strided C (ldc = n + 32),
    with and without op(T) folded in, against ``_project_plain(groups=G)``
    of the same mode (nearer it than the "highest" one in the split
    modes); bitwise reruns."""
    m, nb, n, mr, off = case
    rng = np.random.default_rng(m + n + groups)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda)
    big = torch.from_numpy(rng.standard_normal((m, n + 32), dtype=np.float32)).to(cuda)
    c = big[:, off : off + n]
    tm = (torch.from_numpy(rng.standard_normal((nb, nb), dtype=np.float32)).to(cuda) / nb
          if fold else None)
    plan = panel_apply.project_plan_at(m, n, nb, mr, groups, mode, fold)
    assert plan.groups == groups
    got = panel_apply._launch_project(y, tm, c, mr, mode, plan)
    again = panel_apply._launch_project(y, tm, c, mr, mode, plan)
    own = panel_apply._project_plain(y, c, mr, mode, groups=groups)
    hi = panel_apply._project_plain(y, c, mr, "highest", groups=groups)
    if fold:
        own, hi = tm @ own, tm @ hi
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if mode == "highest":
        assert rel(got, own) <= TOL
    else:
        assert nearer_own_mode(got, own, hi, mode)


@pytest.mark.parametrize("mode", ["highest", "b3"])
def test_panel_project_wrapper_takes_the_plan(cuda, mode):
    """A narrow W over many row blocks (4 tiles, 32 row blocks of 512):
    the wrapper launches the plan's G > 1 and agrees with the plain version
    at that G."""
    m, nb, n = 16384, 256, 256
    plan = panel_apply.project_plan(m, n, nb, 512, _build.sm_count(torch.empty(1, device=cuda)),
                                    mode)
    assert plan.groups > 1
    rng = np.random.default_rng(11)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(cuda)
    got = panel_apply.panel_project(y, c, mode)
    want = panel_apply._project_plain(y, c, 512, mode, groups=plan.groups)
    torch.cuda.synchronize()
    if mode == "highest":
        assert rel(got, want) <= TOL
    else:
        assert nearer_own_mode(got, want, panel_apply._project_plain(
            y, c, 512, "highest", groups=plan.groups), mode)


# (Y rows, C columns, mr, fold, G, ranges) of fp32 phase 1; G and ranges
# None: the card's plan. B6 at panel 29 of 16384² (136 tiles of 35 row
# blocks, one group, 128 chains handed), B7 at window 30 (136 tiles of 17),
# B6 at panel 30 (132 tiles: the whole-tile grid) and at panel 40 (92
# tiles: one wave, which the rule keeps whole), the bare sum at G = 1 (W
# written directly by the block that ends each chain); then schedules the
# rule does not pick, which the kernel runs all the same: G = 3 on a block
# a unit (the middle unit of each chain of 3 on a block that takes a pair
# and hands it on), G = 5 with a short last group as a bare sum
BALANCED_CASES = {
    "b6-panel29": (8960, 8704, 256, True, None, None),
    "b7-window30": (8704, 8704, 512, True, None, None),
    "b6-panel30-whole": (8704, 8448, 512, True, None, None),
    "b6-panel40-one-wave": (6144, 5888, 512, True, None, None),
    "direct": (8960, 8704, 256, False, None, None),
    "g3-inside-chains": (1792, 2304, 256, True, 3, 252),
    "g5-short-last": (3328, 1280, 256, False, 5, 132),
}
# the cases whose plan is the balanced schedule
BALANCED = {"b6-panel29", "b7-window30", "direct", "g3-inside-chains", "g5-short-last"}


def _phase1_inputs(cuda, m, n, off, fold, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((m, 256), dtype=np.float32)).to(cuda)
    big = torch.from_numpy(rng.standard_normal((m, n + 32), dtype=np.float32)).to(cuda)
    tm = (torch.from_numpy(rng.standard_normal((256, 256), dtype=np.float32)).to(cuda) / 256
          if fold else None)
    return y, big[:, off : off + n], tm


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", list(BALANCED_CASES))
def test_balanced_phase1_is_the_whole_tile_grid_bitwise(cuda, case, off):
    """fp32 phase 1 on the plan's schedule against the whole-tile grid at
    the plan's G (the parent's order): bitwise equal, reruns too, on a
    strided C and at an odd column offset (4-byte copies); near the plain
    sums in the same groups; ``PROJECT`` counts the launch by schedule."""
    m, n, mr, fold, groups, ranges = BALANCED_CASES[case]
    balanced = case in BALANCED
    y, c, tm = _phase1_inputs(cuda, m, n, off, fold, seed=m + n)
    plan = (panel_apply.project_plan(m, n, 256, mr, _build.sm_count(c), "highest", fold)
            if groups is None else
            panel_apply.project_plan_at(m, n, 256, mr, groups, "highest", fold, ranges))
    whole = panel_apply.project_plan_at(m, n, 256, mr, plan.groups, "highest", fold)
    assert (plan.ranges > 0) == balanced and whole.ranges == 0
    assert groups is None or plan.groups == groups
    _build.reset_counts()
    got = panel_apply._launch_project(y, tm, c, mr, "highest", plan)
    again = panel_apply._launch_project(y, tm, c, mr, "highest", plan)
    assert _build.PROJECT == ({"balanced": 2, "whole_tiles": 0, "handed": 2 * plan.handed}
                              if balanced else {"balanced": 0, "whole_tiles": 2, "handed": 0})
    parent = panel_apply._launch_project(y, tm, c, mr, "highest", whole)
    own = panel_apply._project_plain(y, c, mr, "highest", groups=plan.groups)
    if fold:
        own = tm @ own
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, parent)
    assert rel(got, own) <= TOL


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("kind", ["b6", "b7"])
def test_b6_b7_on_the_balanced_schedule_keep_the_parents_bits(cuda, kind, off):
    """B6 at panel 29 of 16384² (window 8960 × 8704, carry k = 0) and B7 on
    window 30 (8704²), both on the balanced schedule: bitwise their two
    phases with phase 1 on the whole-tile grid at the plan's G, and near
    their plain twins at that G."""
    nb = 256
    m, n = (8960, 8704) if kind == "b6" else (8704, 8704)
    rng = np.random.default_rng(29 + off)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda) / m ** 0.5
    t = torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32))).to(cuda) / nb
    width = n + nb if kind == "b6" else n
    big = torch.from_numpy(rng.standard_normal((m, width + 4), dtype=np.float32)).to(cuda)

    def view(x):
        return x[:, off : off + width]

    mr = panel_apply._block(m, nb, 512 if kind == "b6" else 1024)
    win = (lambda x: x[:, nb:]) if kind == "b6" else (lambda x: x)
    plan = panel_apply.project_plan(m, n, nb, mr, _build.sm_count(y), "highest", True)
    assert plan.groups == 1 and plan.handed > 0
    got, parent = view(big.clone()), view(big.clone())
    if kind == "b6":
        panel_apply.panel_apply_carry(y, t, got, 0, nb)
        twin = panel_apply.panel_apply_carry_plain(y, t, view(big).clone(), 0, nb, groups=1)
    else:
        panel_apply.panel_apply(y, t, got, precision="highest")
        twin = panel_apply.panel_apply_plain(y, t, view(big).clone(), precision="highest",
                                             groups=1)
    whole = panel_apply.project_plan_at(m, n, nb, mr, 1, "highest", True)
    w = panel_apply._launch_project(y, t.T.contiguous(), win(parent), mr, "highest", whole)
    panel_apply._sub_on_card(y, w, win(parent), "highest")
    torch.cuda.synchronize()
    assert torch.equal(got, parent)
    assert rel(win(got), win(twin)) <= TOL


def test_balanced_phase1_twenty_launches_back_to_back(cuda):
    """Twenty launches of one balanced plan in a row, each zeroing its own
    ticket and flags first: all bitwise the first and the whole-tile
    grid's."""
    m, n, mr = 8960, 8704, 256
    y, c, tm = _phase1_inputs(cuda, m, n, 0, True, seed=20)
    plan = panel_apply.project_plan(m, n, 256, mr, _build.sm_count(c), "highest", True)
    outs = [panel_apply._launch_project(y, tm, c, mr, "highest", plan) for _ in range(20)]
    parent = panel_apply._launch_project(
        y, tm, c, mr, "highest", panel_apply.project_plan_at(m, n, 256, mr, 1, "highest", True))
    torch.cuda.synchronize()
    assert plan.ranges > 0 and all(torch.equal(o, parent) for o in outs)


def test_balanced_phase1_on_two_streams_at_once(cuda):
    """Two streams each launching balanced phase 1 five times, on their own
    inputs, at once: the two launches share the card's SMs, and a block
    that finds no SM free waits for one; each result is bitwise what the
    same launch gives alone on the default stream."""
    m, n, mr = 8960, 8704, 256
    ins = [_phase1_inputs(cuda, m, n, 0, True, seed=s) for s in (31, 32)]
    plan = panel_apply.project_plan(m, n, 256, mr, _build.sm_count(ins[0][1]), "highest", True)
    alone = [panel_apply._launch_project(y, tm, c, mr, "highest", plan) for y, c, tm in ins]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in ins]
    outs = [[], []]
    for _ in range(5):
        for i, ((y, c, tm), st) in enumerate(zip(ins, streams)):
            with torch.cuda.stream(st):
                outs[i].append(panel_apply._launch_project(y, tm, c, mr, "highest", plan))
    torch.cuda.synchronize()
    assert plan.ranges > 0
    for want, got in zip(alone, outs):
        assert all(torch.equal(g, want) for g in got)


def test_hr_qr_at_16384_counts_its_phase1_schedules(cuda):
    """hr qr (reduced) at 16384² (the square-16384-hr cell's size), one
    eager call: ``PROJECT`` equal to ``planned_hr_counts``' derivation
    (60 balanced launches with 7300 chains handed, 63 whole-tile, on 132
    SMs), the launches as planned, the residual at the fp32 level."""
    from tileqr_torch.drivers import square_hr

    n = 16384
    g = torch.Generator(device="cuda").manual_seed(23)
    a = torch.randn((n, n), generator=g, device=cuda)
    a.diagonal().add_(4 * n ** 0.5)
    cfg = tileqr_torch.QRConfig(square_method="hr")
    tileqr_torch.release_graphs()
    _build.reset_counts()
    q, r = tileqr_torch.qr(a, config=cfg)
    torch.cuda.synchronize()
    assert not any(isinstance(v, square_hr._LoopGraphs) for v in square_hr._LOOPS.values())
    want = planned_hr_counts(n, n, 256, sms=_build.sm_count(a))
    assert _build.PROJECT == want["project"]
    if _build.sm_count(a) == 132:
        assert want["project"] == {"balanced": 60, "whole_tiles": 63, "handed": 7300}
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want["launches"]
    assert residuals_f64(a, q, r)["relerr"] <= 3e-6
    tileqr_torch.release_graphs()


@pytest.mark.parametrize("mode", ["highest"] + MODES)
def test_panel_project_without_rows_is_zero(cuda, mode):
    """A slice with no rows (m = 0) launches and gives W = 0."""
    w = panel_apply.panel_project(torch.zeros((0, 64), device=cuda),
                                  torch.zeros((0, 128), device=cuda), mode)
    torch.cuda.synchronize()
    assert torch.equal(w, torch.zeros((64, 128), device=cuda))


@pytest.mark.parametrize("b,m,n,ib", [(1, 512, 256, 128), (2, 2048, 512, 128),
                                      (8, 1024, 128, 64), (1, 256, 256, 128)], ids=str)
def test_geqrt_batched_cluster_route(cuda, b, m, n, ib):
    """Stacks of 1, 2 and 8 (m >= n) take the cluster route, one launch
    counted as ``geqrt_batched[cluster]``, against the plain version;
    bitwise reruns; the input is read only."""
    plan = geqrt.batched_cluster_plan(b, m, n, ib, _build.sm_count(torch.empty(1, device=cuda)))
    assert plan.ctas > 1
    a = torch.from_numpy(np.random.default_rng(b + m).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    before = a.clone()
    _build.reset_counts()
    got = geqrt.geqrt_batched(a, ib)
    assert _build.LAUNCHES["geqrt_batched[cluster]"] == 1 and _build.LAUNCHES["geqrt_batched"] == 0
    again = geqrt.geqrt_batched(a, ib)
    want = geqrt.geqrt_batched_plain(a, ib)
    torch.cuda.synchronize()
    assert torch.equal(a, before)
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, h) and g.shape == w.shape and rel(g, w) <= TOL


# ---- the sharded path: TTQRT, the single-tile entries, B13, B14, a world ----

def tri_pair(cuda, nb, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32)))
                 .to(cuda) for _ in range(2))


@pytest.mark.parametrize("nb", [64, 256])
def test_ttqrt_matches_plain_and_tsqrt_kernel(cuda, nb):
    """TTQRT against its plain version (1e-5) and against the TSQRT kernel
    (K2 with one couple) on the same couple, at the kernel tolerance: both
    run the cluster routine, TTQRT on the couple's live rows only, so their
    sums go in another order."""
    from tileqr_torch.kernels import tsqrt, ttqrt

    r1, r2 = tri_pair(cuda, nb, nb)
    _build.reset_counts()
    got = ttqrt.ttqrt(r1, r2)
    want = ttqrt.ttqrt_plain(r1, r2)
    full = tsqrt.tsqrt(r1, r2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ttqrt"] == 1 and _build.LAUNCHES["panel_chain"] == 1
    for g, w, f in zip(got, want, full):
        assert rel(g, w) <= TOL
        print(f"ttqrt against tsqrt nb={nb}: rel {rel(g, f):.3e}, "
              f"max abs {float((g - f).abs().max()):.3e}")
        assert rel(g, f) <= TOL
    assert torch.equal(torch.tril(got[1], -1), torch.zeros_like(got[1]))


# TTQRT on the cluster routine's live rows (csrc/ttqrt.cu): (nb, ib) with
# ib = nb/2 and 128 where it divides, ragged last blocks (96 of 256, 64 of
# 96); the plan's C: 1 at nb = 32, 2 at 64, 4 at 96, 8 at 256, 16 at 512
# (512/256 in the global workspace)
TTQRT_CASES = [(32, 16), (64, 32), (256, 128), (512, 256), (512, 128), (256, 96), (96, 64)]


@pytest.mark.parametrize("nb,ib", TTQRT_CASES, ids=str)
def test_ttqrt_cluster_matches_plain_and_tsqrt_kernel(cuda, nb, ib):
    from tileqr_torch.kernels import tsqrt, ttqrt

    r1, r2 = tri_pair(cuda, nb, nb + ib)
    plan = ttqrt.ttqrt_plan(nb, ib)
    _build.reset_counts()
    got = ttqrt.ttqrt(r1, r2, ib)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ttqrt"] == 1 and not any(_build.PLAIN_CALLS.values())
    want = ttqrt.ttqrt_plain(r1.cpu(), r2.cpu(), ib)
    full = tsqrt.tsqrt(r1, r2, ib)
    errs = [rel(g.cpu(), w) for g, w in zip(got, want)]
    errs_k2 = [rel(g, f) for g, f in zip(got, full)]
    print(f"TTQRT nb={nb} ib={ib} {plan}: rel to plain {max(errs):.3e}, "
          f"to tsqrt {max(errs_k2):.3e}")
    assert max(errs) <= TOL and max(errs_k2) <= TOL
    for x in got[:2]:
        assert torch.equal(torch.tril(x, -1), torch.zeros_like(x))
    assert torch.equal(torch.tril(got[2], -1), torch.zeros_like(got[2]))


def test_ttqrt_and_modified_lu_rerun_bitwise(cuda):
    """TTQRT at nb = 256 (ib 128) and B8 at nb = 256, each twice: the same bits."""
    from tileqr_torch.kernels import ttqrt

    r1, r2 = tri_pair(cuda, 256, 9)
    q_top = q_top_of(256, "flip", 9).to(cuda)
    runs = [(ttqrt.ttqrt(r1, r2), modlu.modified_lu(q_top)) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("trans", [True, False])
def test_single_tile_entries_match_plain(cuda, trans):
    """tsqrt (K2), larfb (K4), ssrfb and ttmqr (K3 with one couple) at
    nb = 256 against their plain versions."""
    from tileqr_torch.kernels import larfb, ssrfb, tsqrt, ttqrt

    nb = 256
    rng = np.random.default_rng(5)
    r, _ = tri_pair(cuda, nb, 5)
    b, c_top, c_bot = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda)
                       for s in ((nb, nb), (nb, 3 * nb), (nb, 3 * nb)))
    got, want = tsqrt.tsqrt(r, b), tsqrt.tsqrt(r.cpu(), b.cpu())
    for g, w in zip(got, want):
        assert rel(g.cpu(), w) <= TOL
    _, v2, t2 = got
    pk, tg = geqrt.geqrt(b)
    _build.reset_counts()
    outs = [larfb.larfb(pk, tg, c_top, trans=trans)]
    outs += list(ssrfb.ssrfb(v2, t2, c_top, c_bot, trans=trans))
    tt_r1, tt_r2 = tri_pair(cuda, nb, 6)
    _, tv2, tt2 = ttqrt.ttqrt(tt_r1, tt_r2)
    outs += list(ttqrt.ttmqr(tv2, tt2, c_top, c_bot, trans=trans))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["larfb_strip"] == 1 and _build.LAUNCHES["ssrfb"] == 2
    assert _build.LAUNCHES["couple_strip"] == 0
    assert not any(_build.PLAIN_CALLS.values())
    plain = [larfb.larfb_body(pk, tg, c_top, trans)]
    plain += list(ssrfb.ssrfb_body(v2, t2, c_top, c_bot, trans))
    plain += list(ssrfb.ssrfb_body(tv2, tt2, c_top, c_bot, trans))
    for g, w in zip(outs, plain):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("trans,reverse", [(True, False), (False, True)])
def test_couple_apply_and_panel_head_match_plain(cuda, trans, reverse):
    """B14 (K3 with block_rows = nb) and B13 (K1 on a row view into flat
    buffers) at nb = 256 against their plain versions."""
    from tileqr_torch.kernels import update

    nb = 256
    a = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4 * nb, 3 * nb), dtype=np.float32)).to(cuda)
    _, v_stack, tg, t2s = panel.panel_factor_plain(a, 0, nb, nb // 2)
    packed = v_stack.reshape(4 * nb, nb)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        c = a.to(dev).clone()
        _, strip = update.couple_apply(packed.to(dev), tg.to(dev), t2s.to(dev), c, 0, 1, nb,
                                       trans=trans, reverse=reverse)
        outs.append((c[nb:, nb:].cpu(), strip.cpu()))
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert rel(g, w) <= TOL
    heads = []
    for dev in (cuda, torch.device("cpu")):
        vh = torch.zeros((6, nb, nb), device=dev)
        th = torch.zeros((6, nb, nb), device=dev)
        r, t = panel.panel_head(a[:, :nb].to(dev).contiguous(), 1, 2, vh, th, 2, nb, nb // 2)
        heads.append([x.cpu() for x in (r, t, vh, th)])
    torch.cuda.synchronize()
    for g, w in zip(*heads):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("driver", ["auto", "dynamic"])
def test_sharded_2x2_world_on_one_card(cuda, driver):
    """A 2×2 gloo world of spawned ranks sharing the card at 2048², nb = 256
    (8 panels: "auto" → chunk 1, "dynamic" → chunk 4): ‖QᵀA − R‖F/‖A‖F
    ≤ 1e-6, Q(QᵀA) = A, reruns bitwise, rank 0's launches as planned, and
    R against the single-card hh ``qr``'s R with row signs matched."""
    from tileqr_torch.dist import launch

    n = 2048
    a = np.random.default_rng(8).standard_normal((n, n)).astype(np.float32)
    cfg = tileqr_torch.QRConfig(mesh_shape=(2, 2), driver=driver)
    out = launch.run_world(launch.sharded_case, 2, 2, timeout=600,
                           kwargs=dict(a=a, config=cfg, device="cuda"))
    assert out["chunk"] == (1 if driver == "auto" else 4)
    # rank 0's factor: one count per launch, as the geometry plans them
    plan = {k: v for k, v in out["planned"].items() if v}
    assert {k: v for k, v in out["launches"].items() if v} == plan
    assert not any(out["plain"].values())
    r = out["r"].astype(np.float64)
    a64 = a.astype(np.float64)
    assert np.linalg.norm(out["qta"] - r) / np.linalg.norm(a64) <= 1e-6
    assert np.linalg.norm(out["qqtc"] - a64) / np.linalg.norm(a64) <= 1e-5
    assert np.array_equal(out["r"], out["r2"])
    r_hh = tileqr_torch.qr(torch.from_numpy(a).to(cuda), mode="r").double().cpu().numpy()
    s = np.sign(np.diag(r)) * np.sign(np.diag(r_hh))
    s[s == 0] = 1
    assert np.linalg.norm(r * s[:, None] - r_hh) / np.linalg.norm(r_hh) <= 1e-5


# ---- the sharded hr path: B7's halves, a world ----

@pytest.mark.parametrize("nb", [64, 256])
@pytest.mark.parametrize("mode", ["highest"] + MODES)
def test_panel_halves_match_plain(cuda, nb, mode):
    """B7a ``panel_project`` (3 Kahan row blocks of 512) and B7b
    ``panel_sub`` on a strided window of a larger C, against their plain
    versions in the same mode: the launch counted under the mode's
    instantiation, C updated in place and untouched outside the window."""
    rng = np.random.default_rng(nb)
    m, n = 1536, 3 * nb
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda)
    big = torch.from_numpy(rng.standard_normal((m, n + nb), dtype=np.float32)).to(cuda)
    c = big[:, nb:]
    w = torch.from_numpy(rng.standard_normal((nb, n), dtype=np.float32)).to(cuda)
    _build.reset_counts()
    got = panel_apply.panel_project(y, c, mode)
    want = panel_apply.panel_project_plain(y, c, mode)
    hi = panel_apply.panel_project_plain(y, c, "highest")
    cw = big.clone()
    out = panel_apply.panel_sub(y, w, cw[:, nb:], mode)
    want_sub = panel_apply.panel_sub_plain(y, w, big.clone()[:, nb:], mode)
    hi_sub = panel_apply.panel_sub_plain(y, w, big.clone()[:, nb:], "highest")
    torch.cuda.synchronize()
    key = {"highest": "", "b3": "[b3]", "b4": "[b4]", "default": "[default]"}[mode]
    assert _build.LAUNCHES[f"panel_project{key}"] == 1 == _build.LAUNCHES[f"panel_sub{key}"]
    assert out.data_ptr() == cw[:, nb:].data_ptr() and torch.equal(cw[:, :nb], big[:, :nb])
    if mode == "highest":
        assert rel(got, want) <= TOL and rel(out, want_sub) <= TOL
    else:
        assert nearer_own_mode(got, want, hi, mode)
        assert nearer_own_mode(out, want_sub, hi_sub, mode)


def test_panel_halves_raise_on_the_card(cuda):
    """float64, an nb the fp32 instantiation does not take, c rows != y
    rows: each raises, nothing falls back to the plain version."""
    y = torch.zeros((1024, 512), device=cuda)
    c = torch.zeros((1024, 512), device=cuda)
    _build.reset_counts()
    with pytest.raises(TypeError):
        panel_apply.panel_project(y.double(), c.double(), "b3")
    with pytest.raises(ValueError, match="nb"):
        panel_apply.panel_project(y, c, "highest")
    with pytest.raises(ValueError, match="nb"):
        panel_apply.panel_sub(y, torch.zeros((512, 512), device=cuda), c, "highest")
    with pytest.raises(ValueError, match="c rows"):
        panel_apply.panel_sub(y, torch.zeros((512, 512), device=cuda), c[:512], "b3")
    assert not any(_build.PLAIN_CALLS.values()) and not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("mode", ["highest", "b3"])
def test_sharded_hr_2x1_world_on_one_card(cuda, mode):
    """A 2×1 gloo world of spawned ranks sharing the card runs the hr
    sharded path at 2048², nb = 256 (8 panels, 8 segments): rank 0's
    factor launches equal ``planned_launches_hr`` (B9 and B8 on every
    panel, B7's halves on every panel in b3 and on none in "highest"), no
    plain version runs, ‖QᵀA − R‖F/‖A‖F within the mode's
    limit, Q(QᵀA) = A, reruns and the replicated factors bitwise equal,
    and R against the single-card hr R with row signs matched."""
    from tileqr_torch.dist import launch

    n = 2048
    a = np.random.default_rng(9).standard_normal((n, n)).astype(np.float32)
    cfg = tileqr_torch.QRConfig(mesh_shape=(2, 1), square_method="hr", precision=mode)
    out = launch.run_world(launch.sharded_hr_case, 2, 1, timeout=600,
                           kwargs=dict(a=a, config=cfg, device="cuda"))
    plan = {k: v for k, v in out["planned"].items() if v}
    assert {k: v for k, v in out["launches"].items() if v} == plan
    assert plan["potrf_batched"] == plan["modified_lu"] == 8
    assert out["planned"]["panel_sub[b3]" if mode == "b3" else "panel_sub"] == (8 if mode == "b3"
                                                                               else 0)
    assert not any(out["plain"].values())
    assert out["same"] and len(set(out["replicated"])) == 1
    tol = 1e-6 if mode == "highest" else 1e-4
    r = out["r"].astype(np.float64)
    a64 = a.astype(np.float64)
    assert np.linalg.norm(out["qtc"] - r) / np.linalg.norm(a64) <= tol
    assert np.linalg.norm(out["qqtc"] - a64) / np.linalg.norm(a64) <= 10 * tol
    r_hr = tileqr_torch.qr(torch.from_numpy(a).to(cuda), mode="r", config=tileqr_torch.QRConfig(
        square_method="hr")).double().cpu().numpy()
    s = np.sign(np.diag(r)) * np.sign(np.diag(r_hr))
    s[s == 0] = 1
    assert np.linalg.norm(r * s[:, None] - r_hr) / np.linalg.norm(r_hr) <= 100 * tol


# ---- K3's stages and phase 2 at every plan (strip_plan, sub_plan) ----

ALL_MODES = ["highest"] + MODES
# (nb, C columns, col_start, block_rows, n_chunks, stage-1 tile size, G,
# stage-3 tile size): narrow late-panel strips of 256 and 512 columns, a
# ragged width, G > 1, chunk-1 couples (B14's), large and small tiles
STRIP_GEOS = {
    "nb64-ragged-G4-small": (64, 3 * 64 + 40, 1, 128, 2, "small", 4, "small"),
    "nb256-w256-G2-small": (256, 2 * 256, 1, 512, 2, "small", 2, "large"),
    "nb256-w512-G1-large": (256, 3 * 256, 1, 512, 2, "large", 1, "small"),
    "nb64-chunk1-G2": (64, 9 * 64, 1, 64, 4, "large", 2, "large"),
    "nb64-cs0-w512-G1": (64, 8 * 64, 0, 128, 2, "small", 1, "small"),
}
STRIP_VARIANTS_CARD = [(True, False, True), (False, True, True), (True, False, False),
                       (False, True, False), (True, True, True)]


def strip_case(cuda, nb, cols, block_rows, n_chunks, seed=5):
    """C ((1 + n_chunks)·block_rows, cols) gaussian: its first tile's K1
    (packed V, T) and K2's n_chunks couples of block_rows rows from row
    block 1 on, from the plain versions."""
    rng = np.random.default_rng(seed + nb + cols)
    a = torch.from_numpy(rng.standard_normal(((1 + n_chunks) * block_rows, cols),
                                             dtype=np.float32)).to(cuda)
    col = a[:, :nb].contiguous()
    k1 = panel.panel_factor_plain(col, 0, nb, nb // 2, 0)
    k2 = chain.panel_chain_plain(col, k1[0], 0, nb, 1, n_chunks, block_rows, nb // 2)
    return a, k1, k2


@pytest.mark.parametrize("geo", list(STRIP_GEOS), ids=str)
@pytest.mark.parametrize("trans,reverse,fused", STRIP_VARIANTS_CARD,
                         ids=["t-fwd-fused", "n-rev-fused", "t-fwd", "n-rev", "t-rev-fused"])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_couple_strip_at_every_plan(cuda, geo, trans, reverse, fused, mode):
    """K3 at a given plan (tiles, G) against the plain version of its mode
    summed in the same groups (nearer it than the "highest" one in the
    split modes); bitwise reruns; the rows and columns outside the strip
    and the couples untouched."""
    nb, cols, cs, br, nc, ptile, groups, stile = STRIP_GEOS[geo]
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = strip_case(cuda, nb, cols, br, nc)
    width = cols - cs * nb
    large, small = panel_apply.tiles_for(mode)
    plan = chain.strip_plan_at(nb, width, br, nc, large if ptile == "large" else small, groups,
                               large if stile == "large" else small, fused)
    vkk, tgf = (v_stack[0], tg) if fused else (None, None)
    outs = []
    for fn, prec in ((chain._launch_strip, mode), (chain._launch_strip, mode),
                     (chain.couple_strip_plain, mode), (chain.couple_strip_plain, "highest")):
        c = a.clone()
        args = (v_chunks, t2, c, c[:nb, cs * nb :], 0, 1, nc, br, nb, cs, trans, reverse, vkk,
                tgf, prec)
        if fn is chain._launch_strip:
            fn(*args, plan)
        else:
            fn(*args, groups=plan.groups)
        outs.append(c)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # reruns are bitwise equal
    assert torch.equal(outs[0][nb:br], a[nb:br]) and torch.equal(outs[0][:, : cs * nb],
                                                                 a[:, : cs * nb])
    if mode == "highest":
        assert rel(outs[0], outs[2]) <= TOL
    else:
        assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


@pytest.mark.parametrize("width", [256, 512, 200])
@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_larfb_strip_at_narrow_widths(cuda, width, trans, mode):
    """K4 (the chain launch alone) on late-panel and ragged widths in every
    mode, against the plain version of its mode; bitwise reruns."""
    nb = 256
    a, (_, v_stack, tg, _), _ = strip_case(cuda, nb, width + nb, nb, 1)
    outs = []
    for fn, prec in ((chain.larfb_strip, mode), (chain.larfb_strip, mode),
                     (chain.larfb_strip_plain, mode), (chain.larfb_strip_plain, "highest")):
        s = a[:nb, nb:].clone()
        fn(v_stack[0], tg, s, nb, trans=trans, precision=prec)
        outs.append(s)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    if mode == "highest":
        assert rel(outs[0], outs[2]) <= TOL
    else:
        assert nearer_own_mode(outs[0], outs[2], outs[3], mode)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_couple_strip_wrapper_counts_one_launch(cuda, mode):
    """A K3 call launches three kernels and counts once, under its mode's
    key (and under ``counter``)."""
    nb = 64
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = factors(cuda, nb)
    _build.reset_counts()
    c = a.clone()
    chain.couple_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, 2, 2 * nb, nb, 1, vkk=v_stack[0],
                       tg=tg, precision=mode)
    chain.couple_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, 2, 2 * nb, nb, 1, precision=mode,
                       counter="ssrfb")
    chain.larfb_strip(v_stack[0], tg, c[:nb, nb:], nb, precision=mode)
    torch.cuda.synchronize()
    key = {"highest": "", "b3": "[b3]", "b4": "[b4]", "default": "[default]"}[mode]
    assert _build.LAUNCHES[f"couple_strip{key}"] == 1 == _build.LAUNCHES[f"ssrfb{key}"]
    assert _build.LAUNCHES[f"larfb_strip{key}"] == 1
    assert not any(_build.PLAIN_CALLS.values())


@pytest.mark.parametrize("nb", [40, 512, 768])
@pytest.mark.parametrize("tile", ["large", "small"])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_phase2_at_any_nb_and_tile(cuda, nb, tile, mode):
    """Phase 2 (``tq_panel_sub``) at nb 40/512/768 on a ragged n, a strided
    C at an odd column offset (4-byte copies) and a Y and W at misaligned
    addresses, on each tile of its route: against the plain C − Y·W of its
    mode; bitwise reruns; C untouched outside the window."""
    rng = np.random.default_rng(nb + len(tile))
    m, n = 2 * max(nb, 512) + 64, 2 * nb + 13  # neither a multiple of any tile
    flat = torch.from_numpy(rng.standard_normal(m * nb + nb * n + 2, dtype=np.float32)).to(cuda)
    y = flat[1 : 1 + m * nb].view(m, nb)            # 4 bytes past a 16-byte boundary
    w = flat[2 + m * nb : 2 + m * nb + nb * n].view(nb, n)
    big = torch.from_numpy(rng.standard_normal((m, n + 37), dtype=np.float32)).to(cuda)
    large, small = panel_apply.tiles_for(mode)
    t = large if tile == "large" else small
    outs = []
    for _ in range(2):
        b = big.clone()
        panel_apply._launch_sub(y, w, b[:, 3 : 3 + n], mode, panel_apply.SubPlan(t))
        outs.append(b)
    own = big.clone()
    own[:, 3 : 3 + n] -= panel_apply.dot(y, w, mode)
    hi = big.clone()
    hi[:, 3 : 3 + n] -= y @ w
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][:, :3], big[:, :3]) and torch.equal(outs[0][:, 3 + n :],
                                                                    big[:, 3 + n :])
    if mode == "highest":
        assert rel(outs[0], own) <= TOL
    else:
        assert nearer_own_mode(outs[0], own, hi, mode)


def test_plans_refuse_what_their_layouts_lack(cuda):
    """A tile no route has, a split tile in "highest", an fp32 tile in b3,
    and a G whose groups are not whole (3 groups of a 128-row couple) are
    refused by the C entries; nothing falls back."""
    y = torch.zeros((256, 64), device=cuda)
    w = torch.zeros((64, 128), device=cuda)
    c = torch.zeros((256, 128), device=cuda)
    for mode, tile in (("highest", (32, 32)), ("highest", (128, 64)), ("b3", (128, 128)),
                       ("b3", (64, 128))):
        with pytest.raises(RuntimeError, match="panel_sub"):
            panel_apply._launch_sub(y, w, c, mode, panel_apply.SubPlan(tile))
    nb = 64
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = factors(cuda, nb)
    bad = chain.StripPlan((128, 128), 3, 64, (128, 128), 64, 2 * 4 * nb * 2 * nb)
    with pytest.raises(RuntimeError, match="couple_strip"):
        chain._launch_strip(v_chunks, t2, a.clone(), a.clone()[:nb, nb:], 0, 1, 2, 2 * nb, nb,
                            1, True, False, None, None, "highest", bad)


@pytest.mark.parametrize("case", ["qr", "tree-r", "cholqr2-factor", "tree-reduced", "upload",
                                  "batched-hh", "batched-cholqr2"])
def test_every_host_sync_is_a_sync_span(cuda, case):
    """One call of each benchmark cell's entry at a small shape (and the
    tree's Q, and a numpy input; the batched cells' on 512 members) under ``set_sync_debug_mode("warn")``:
    every synchronising CUDA operation warns, and the warnings are as many
    as the ``tileqr_torch.sync.*`` spans, so the spans miss no sync. The
    tall route's schedule is dropped first, so that its one-time copy
    happens inside the call."""
    import warnings

    rng = np.random.default_rng(14)
    sq = torch.from_numpy(rng.standard_normal((1024, 1024), dtype=np.float32)).to(cuda)
    # 128 leaves of 2048×512: the tall route, then four levels
    tall = torch.from_numpy(rng.standard_normal((262144, 512), dtype=np.float32)).to(cuda)
    cfg = tileqr_torch.QRConfig(nb=512)
    host = sq.cpu().numpy()
    # a stack of the batched cells' members, G + 4·√n·I
    stack = torch.from_numpy(rng.standard_normal((512, 128, 128), dtype=np.float32)).to(cuda)
    stack += 4 * 128 ** 0.5 * torch.eye(128, device=cuda)
    chol = tileqr_torch.QRConfig(batched_method="cholqr2")
    call = {"qr": lambda: tileqr_torch.qr(sq),
            "batched-hh": lambda: tileqr_torch.qr_batched(stack),
            "batched-cholqr2": lambda: tileqr_torch.qr_batched(stack, config=chol),
            "tree-r": lambda: tileqr_torch.tsqr(tall, "r", cfg, strategy="tree"),
            "cholqr2-factor": lambda: tileqr_torch.tsqr(tall, "factor", cfg),
            "tree-reduced": lambda: tileqr_torch.tsqr(tall, "reduced", cfg, strategy="tree"),
            "upload": lambda: tileqr_torch.qr(host)}[case]
    call()  # warm: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    geqrt._tall_ops.cache_clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # each synchronising operation warns "called a synchronizing CUDA operation"
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    spans = [e.name for e in prof.events() if e.name.startswith("tileqr_torch.sync.")]
    want = {"qr": [], "tree-r": ["tall_ops"], "cholqr2-factor": ["guard"],
            "tree-reduced": ["tall_ops"] + ["tree_index"] * 4, "upload": ["upload"],
            "batched-hh": [], "batched-cholqr2": ["guard"]}[case]
    assert sorted(spans) == sorted(f"tileqr_torch.sync.{s}" for s in want)
    assert len(syncs) == len(spans), syncs


# ---- K3's chain by row bands (chain.chain_bands: 1, 2 or 4 CTAs a block) ----

BAND_WIDTHS = [64, 200, 256, 1024, 7936]
# (trans, reverse, fused, couples): the factor's sweep, Q's, each without
# the LARFB, a forward non-trans one, and K4 (the chain alone)
BAND_VARIANTS = [(True, False, True, 2), (False, True, True, 2), (True, False, False, 2),
                 (False, True, False, 2), (False, False, True, 2), (True, False, True, 0),
                 (False, False, True, 0)]


def strip_at_bands(cuda, width, trans, reverse, fused, couples, mode, bands_list, seed=5):
    """K3 (K4 with no couples) on an nb = 256 strip of ``width`` columns
    (couples of 512 rows) through ``_launch_strip`` at the card's plan with
    each band count of ``bands_list`` in turn: the C of each, with the
    inputs."""
    nb, br = 256, 512
    a, (_, v_stack, tg, _), (_, v_chunks, t2) = strip_case(cuda, nb, width + nb, br,
                                                           max(couples, 1), seed)
    card = chain.strip_plan(nb, width, br, couples, _build.sm_count(a), mode, fused=fused)
    vkk, tgf = (v_stack[0], tg) if fused else (None, None)
    outs = []
    for bands in bands_list:
        plan = card._replace(bands=bands)
        c = a.clone()
        chain._launch_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, couples, br, nb, 1, trans,
                            reverse, vkk, tgf, mode, plan)
        outs.append(c)
    torch.cuda.synchronize()
    return outs, (a, v_stack, tg, v_chunks, t2, card)


@pytest.mark.parametrize("width", BAND_WIDTHS)
@pytest.mark.parametrize("trans,reverse,fused,couples", BAND_VARIANTS,
                         ids=["t-fwd-fused", "n-rev-fused", "t-fwd", "n-rev", "n-fwd-fused",
                              "k4-t", "k4-n"])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_chain_bands_keep_the_bits(cuda, width, trans, reverse, fused, couples, mode):
    """K3 and K4 at 1, 2 and 4 row bands a block (the plan's own count
    among them): bitwise the same C at every count, rerun bitwise, and
    within the tolerance of the plain version of the mode (nearer it than
    the "highest" one in the split modes)."""
    outs, (a, v_stack, tg, v_chunks, t2, card) = strip_at_bands(
        cuda, width, trans, reverse, fused, couples, mode, [1, 2, 4, 4])
    assert card.bands == chain.chain_bands(256, width, _build.sm_count(a))
    for i in (1, 2, 3):
        assert torch.equal(outs[i], outs[0]), i
    nb, br = 256, 512
    want = []
    for prec in (mode, "highest"):
        c = a.clone()
        chain.couple_strip_plain(v_chunks, t2, c, c[:nb, nb:], 0, 1, couples, br, nb, 1,
                                 trans, reverse, v_stack[0] if fused else None,
                                 tg if fused else None, prec, groups=card.groups)
        want.append(c)
    if mode == "highest":
        assert rel(outs[0], want[0]) <= TOL
    else:
        assert nearer_own_mode(outs[0], want[0], want[1], mode)


def test_chain_bands_are_what_the_wrappers_take(cuda):
    """``couple_strip`` and ``larfb_strip`` launch at ``strip_plan``'s bands:
    the same bits as ``_launch_strip`` at one band; ``CHAIN`` counts K3's."""
    nb, width = 256, 256
    outs, (a, v_stack, tg, v_chunks, t2, card) = strip_at_bands(
        cuda, width, True, False, True, 2, "highest", [1])
    assert card.bands == 4
    _build.reset_counts()
    c = a.clone()
    chain.couple_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, 2, 512, nb, 1, vkk=v_stack[0], tg=tg)
    s = a[:nb, nb:].clone()
    chain.larfb_strip(v_stack[0], tg, s, nb)
    torch.cuda.synchronize()
    assert torch.equal(c, outs[0])
    assert _build.CHAIN == {4: {"launches": 1, "couples": 2}}
    k4, _ = strip_at_bands(cuda, width, True, False, True, 0, "highest", [1])
    assert torch.equal(s, k4[0][:nb, nb:])


@pytest.mark.parametrize("bands", [1, 4])
def test_chain_bands_under_graph_capture(cuda, bands):
    """K3 at 1 and 4 bands captured in a CUDA graph and replayed: the eager
    call's bits."""
    nb, br, width = 256, 512, 256
    eager, (a, v_stack, tg, v_chunks, t2, card) = strip_at_bands(
        cuda, width, True, False, True, 2, "highest", [bands])
    plan = card._replace(bands=bands)
    c = a.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            chain._launch_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, 2, br, nb, 1, True, False,
                                v_stack[0], tg, "highest", plan)
    torch.cuda.current_stream().wait_stream(stream)
    c.copy_(a)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(c, eager[0])


def test_chain_bands_on_a_strip_of_no_16_byte_copies(cuda):
    """An odd width (the 4-byte copies and scalar W sums) at 1, 2 and 4
    bands: the same bits, and the plain version's values."""
    outs, (a, v_stack, tg, v_chunks, t2, card) = strip_at_bands(
        cuda, 157, False, True, True, 2, "highest", [1, 2, 4])
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    c = a.clone()
    chain.couple_strip_plain(v_chunks, t2, c, c[:256, 256:], 0, 1, 2, 512, 256, 1, False, True,
                             v_stack[0], tg, groups=card.groups)
    assert rel(outs[2], c) <= TOL


def k3_panel0_digests() -> dict:
    """sha256 prefixes of K3 at the hh path's panel 0 of 8192² (gaussian A
    from default_rng(21); K1 with 3 head couples, K2 with 7 chunks of 1024
    rows): the chunks on the 7936-column strip forward (the factor's
    update) and in reverse with the LARFB fused (Q's order); and the
    panel's whole sweep (``strip_sweep``) as the narrow update runs it on
    256 columns and as Q's formation on 1024."""
    import hashlib

    def bits(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]

    n, nb = 8192, 256
    a = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (n, n), dtype=np.float32)).cuda()
    r, v_stack, tg, t2h = panel.panel_factor(a, 0, nb, 128, 3)
    _, v_chunks, t2 = chain.panel_chain(a, r, 0, nb, 1, 7, 4 * nb, 128)
    got = {}
    for name, kw in (("forward", {}), ("reverse fused", dict(trans=False, reverse=True,
                                                             vkk=v_stack[0], tg=tg))):
        c = a.clone()
        chain.couple_strip(v_chunks, t2, c, c[:nb, nb:], 0, 1, 7, 4 * nb, nb, 1, **kw)
        got[name] = bits(c)
    for name, width, cs, trans in (("narrow update", nb, 1, True), ("Q sweep 1024", 4 * nb, 0,
                                                                    False)):
        c = a[:, : cs * nb + width].clone()
        strip = c[:nb, cs * nb :]
        chain.strip_sweep((v_stack, t2h, c, strip, 1, 1, 3, nb, nb, cs),
                          (v_chunks, t2, c, strip, 0, 1, 7, 4 * nb, nb, cs), v_stack[0], tg,
                          strip, nb, trans=trans)
        got[name] = bits(c)
    return got


# k3_panel0_digests() from the build before the chain's row bands (one CTA a
# block over all nb k) on the card
K3_PARENT_BITS = {"forward": "ae1e8b2988c06867", "reverse fused": "49cbe2cb68619481",
                  "narrow update": "abc419cec609aaf5", "Q sweep 1024": "842623bbd4bde1b7"}


def test_k3_keeps_the_bits_of_one_cta_a_block(cuda):
    assert k3_panel0_digests() == K3_PARENT_BITS


@pytest.mark.parametrize("n", [8192, 16384])
def test_qr_chain_bands_are_what_the_plans_give(cuda, n):
    """hh qr (reduced) at the cells' sizes: K3's chain launches by row bands
    (``_build.CHAIN``) are what ``planned_hh_counts`` derives: 4 bands on
    every narrow update's calls, 1 on the wide rests; R's residual at the
    fp32 Householder level."""
    a = torch.randn((n, n), generator=torch.Generator(device="cuda").manual_seed(n),
                    device=cuda)
    _build.reset_counts()
    q, r = tileqr_torch.qr(a)
    torch.cuda.synchronize()
    want = planned_hh_counts(n, 256, 128, 4, _build.sm_count(a))
    assert _build.CHAIN == want["chain"] and _build.STRIP == want["strip"]
    assert want["chain"][4]["launches"] >= n // 256 - 1 and 1 in want["chain"]
    assert residuals_f64(a, q, r)["relerr"] <= 5e-6

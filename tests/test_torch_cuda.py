"""tileqr_torch's CUDA kernels on the card, against their plain versions,
both square paths (hh and hr), tsqr and qr_batched end to end, and the
split-product instantiations of K3, K4, B6 and B7 in each emulated
precision mode.

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


# (B, m, n, ib): the shared-memory variant (up to 4(mn + n² + m) <= 200 KiB,
# m < n included) and the global-workspace one (a tall leaf, a 256² tile,
# and n = 8 leaves of 131072 rows whose reflector is past shared memory)
GEQRT_CASES = [(64, 128, 128, 32), (16, 128, 128, 128), (5, 72, 40, 32), (3, 32, 48, 16),
               (3, 2048, 64, 64), (2, 256, 256, 128), (2, 131072, 8, 8)]


@pytest.mark.parametrize("b,m,n,ib", GEQRT_CASES,
                         ids=[f"{b}x{m}x{n}-ib{ib}" for b, m, n, ib in GEQRT_CASES])
def test_geqrt_batched_matches_plain(cuda, b, m, n, ib):
    a = torch.from_numpy(np.random.default_rng(m + n).standard_normal(
        (b, m, n), dtype=np.float32)).to(cuda)
    before = a.clone()
    got = geqrt.geqrt_batched(a, ib)
    again = geqrt.geqrt_batched(a, ib)
    want = geqrt.geqrt_batched_plain(a, ib)
    torch.cuda.synchronize()
    assert torch.equal(a, before)  # the input is read only
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, h)  # reruns are bitwise equal
        assert g.shape == w.shape and rel(g, w) <= TOL


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
    own = {"tree": "geqrt_batched", "cholqr2": "potrf_batched", "chain": "panel_factor"}
    assert _build.LAUNCHES[own[strategy]] > 0
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
    own, other = (("geqrt_batched", "potrf_batched") if method == "hh"
                  else ("potrf_batched", "geqrt_batched"))
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
    blocks, in "highest" and in b3."""
    nb, m, n = 64, 512, 96
    rng = np.random.default_rng(passes)
    y = torch.from_numpy(rng.standard_normal((m, nb), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(cuda)
    w = torch.empty((nb, n), device=cuda)
    rc = _build.lib().tq_panel_project(y.data_ptr(), None, c.data_ptr(), c.stride(0), m, n,
                                       nb, m // 2, w.data_ptr(), passes, _build.stream())
    assert rc == 0
    torch.cuda.synchronize()
    assert rel(w, y.double().T @ c.double()) <= (1e-6 if passes == 0 else 1e-5)


# ---- the sharded path: TTQRT, the single-tile entries, B13, B14, a world ----

def tri_pair(cuda, nb, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.triu(rng.standard_normal((nb, nb), dtype=np.float32)))
                 .to(cuda) for _ in range(2))


@pytest.mark.parametrize("nb", [64, 256])
def test_ttqrt_matches_plain_and_tsqrt_kernel(cuda, nb):
    """TTQRT against its plain version (1e-5) and against the TSQRT kernel
    (K2 with one couple) on the same couple: equal up to the sign of zero,
    since the rows past the live window only add exact zeros."""
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
        assert torch.equal(g, f)
    assert torch.equal(torch.tril(got[1], -1), torch.zeros_like(got[1]))


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

"""tileqr_torch's public surface in the precision modes ("b3", "b4",
"default", "high") on both square paths, against tileqr on the same numpy
inputs (JAX on the CPU, Pallas in interpret mode), and the entries where
both packages refuse a mode.

Tolerances, each with its reason:
- "b3"/"b4" in float32 against tileqr: relative Frobenius ≤ 1e-4 on every
  output, and the factorization's error ‖A − QR‖F/‖A‖F within 10% of
  tileqr's in the same mode (the modes' own errors are ~1e-5, "highest"'s
  ~4e-7, b4's 15-25% below b3's). The two packages split the same values
  the same way at the same sites (round to nearest in the kernels,
  truncation in the hr driver's products) and differ only in the order of
  fp32 sums: one kernel call agrees to 1e-7..4e-6
  (tests/test_torch_precision.py). But the lo half is quantized at 2⁻¹⁷ of
  its operand, so a 1e-7 difference in an intermediate operand moves about
  1% of a product's entries by one quantum (7.6e-6), and over the QR's
  chain of dependent products the outputs of the two packages drift apart
  to a few 1e-5 (measured: 2e-6..4.6e-5 at these shapes), as far as the
  reference's own b3 lies from its b4. lstsq runs on the tall shape only:
  a 128² gaussian's condition number (~1e3) multiplies that drift in x;
- float64 in every mode: the port's result is its "highest" result
  bitwise (the exact product), and within 1e-12 of tileqr's on both paths
  (measured: 3e-15 at most);
- "default": tileqr's CPU "default" is the fp32 product, so the port's
  one bf16 pass is held to its own error class instead: ‖A − QR‖F/‖A‖F
  below 5e-2 and above 1e-4 (it is not the fp32 product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tileqr
import tileqr_torch

SPLIT_MODES = ("b3", "b4")
TOL32, TOL64 = 1e-4, 1e-12
NB = 32
SHAPES = {"tall": (128, 96), "square": (128, 128)}
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}
TDT = {np.float32: torch.float32, np.float64: torch.float64}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def cfgs(method, mode, dt):
    """tileqr's config runs the driver the port's one driver stands for: the
    static hh driver, and on hr the kernel route in float32 (``dynamic``,
    B6 on every panel) and the XLA route in float64 (its kernels refuse
    float64)."""
    driver = "dynamic" if method == "hr" and dt is np.float32 else "static"
    j = tileqr.QRConfig(nb=NB, ib=NB // 2, square_method=method, precision=mode,
                        dtype=JDT[dt], driver=driver)
    t = tileqr_torch.QRConfig(nb=NB, ib=NB // 2, square_method=method, precision=mode,
                              dtype=TDT[dt])
    return j, t


def inputs(shape, dt):
    rng = np.random.default_rng(sum(shape))
    return rng.standard_normal(shape).astype(dt), rng.standard_normal((shape[0], 3)).astype(dt)


def results(api, a, c, cfg, **kw):
    """qr (reduced), the factors' R, apply_q both ways, orgqr and lstsq."""
    q, r = api.qr(a, "reduced", cfg, **kw)
    f = api.qr_factor(a, cfg, **kw)
    out = {"q": q, "r": r, "qc": api.apply_q(f, c, trans=False, config=cfg),
           "qtc": api.apply_q(f, c, trans=True, config=cfg), "orgqr": api.orgqr(f, None, cfg)}
    if a.shape[0] > a.shape[1]:
        out["lstsq"] = api.lstsq(a, c, cfg, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref():
    """tileqr's results per (method, shape, mode, dtype), computed once."""
    cache = {}

    def get(method, shape, mode, dt):
        key = (method, shape, mode, dt)
        if key not in cache:
            a, c = inputs(SHAPES[shape], dt)
            jcfg, _ = cfgs(method, mode, dt)
            cache[key] = results(tileqr, a, c, jcfg)
        return cache[key]

    return get


def port(method, shape, mode, dt):
    a, c = inputs(SHAPES[shape], dt)
    _, tcfg = cfgs(method, mode, dt)
    return results(tileqr_torch, a, c, tcfg, device="cpu")


@pytest.mark.parametrize("method", ["hh", "hr"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_split_modes_match_tileqr_in_float32(ref, method, shape, mode):
    got, want = port(method, shape, mode, np.float32), ref(method, shape, mode, np.float32)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k], want[k]) <= TOL32, (k, rel(got[k], want[k]))
    a = inputs(SHAPES[shape], np.float32)[0]
    err, want_err = qr_error(a, got), qr_error(a, want)
    assert abs(err / want_err - 1) <= 0.1, (err, want_err)
    assert err > 10 * qr_error(a, port(method, shape, "highest", np.float32))


def qr_error(a, out):
    """‖A − QR‖F/‖A‖F in float64."""
    a = a.astype(np.float64)
    return np.linalg.norm(a - out["q"].astype(np.float64) @ out["r"].astype(np.float64)) / (
        np.linalg.norm(a))


@pytest.mark.parametrize("method", ["hh", "hr"])
@pytest.mark.parametrize("mode", ["b3", "b4", "high", "default"])
def test_float64_is_exact_in_every_mode(ref, method, mode):
    got = port(method, "tall", mode, np.float64)
    hi = port(method, "tall", "highest", np.float64)
    want = ref(method, "tall", mode, np.float64)
    for k in want:
        assert np.array_equal(got[k], hi[k]), k
        assert rel(got[k], want[k]) <= TOL64, (k, rel(got[k], want[k]))


@pytest.mark.parametrize("method", ["hh", "hr"])
def test_default_is_the_one_pass_error_class(method):
    """On G + 4·√n·I: "default"'s bf16 update error (~4e-3 of each
    product) reaches a gaussian's smallest singular values, where the hr
    guard trips and x has no accuracy left to check."""
    g, c = inputs(SHAPES["square"], np.float32)
    a = g + np.float32(4 * np.sqrt(g.shape[0])) * np.eye(g.shape[0], dtype=np.float32)
    _, tcfg = cfgs(method, "default", np.float32)
    out = results(tileqr_torch, a, c, tcfg, device="cpu")
    assert 1e-4 < qr_error(a, out) < 5e-2
    x = tileqr_torch.lstsq(a, c, tcfg, device="cpu")
    assert rel(x, np.linalg.solve(a.astype(np.float64), c.astype(np.float64))) < 5e-2


@pytest.mark.parametrize("method", ["hh", "hr"])
def test_high_is_b3_bitwise(method):
    """"high" runs b3's kernel instantiations, so every output a kernel
    makes is b3's bitwise: all of hh's, and hr's factors, Q and orgqr. hr's
    applies to c's 3 columns (and lstsq's), which no kernel takes, run the
    three products of the reference's ``_dot``: b3 with its truncating
    split, "high" with the round-to-nearest split of XLA's HIGH. There the
    two differ by the splits' rounding only, within the b3 class (~5e-5
    measured; the mode's own error is ~1e-5 of each product)."""
    a, c = inputs(SHAPES["tall"], np.float32)
    outs = [results(tileqr_torch, a, c, cfgs(method, m, np.float32)[1], device="cpu")
            for m in ("high", "b3")]
    ragged = ("qc", "qtc", "lstsq") if method == "hr" else ()
    for k in outs[1]:
        if k in ragged:
            assert not np.array_equal(outs[0][k], outs[1][k]), k
            assert rel(outs[0][k], outs[1][k]) <= TOL32, (k, rel(outs[0][k], outs[1][k]))
        else:
            assert np.array_equal(outs[0][k], outs[1][k]), k


# --- where both packages refuse a mode ------------------------------------

TS = np.random.default_rng(3).standard_normal((256, 32)).astype(np.float32)
SQ = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
BA = np.random.default_rng(5).standard_normal((4, 32, 16)).astype(np.float32)


def _entry(api, name, mode, **dev):
    def cfg(**kw):
        return api.QRConfig(nb=32, ib=16, precision=mode, **kw)

    calls = {
        "qr hh": lambda: api.qr(SQ, config=cfg(), **dev),
        "qr hr": lambda: api.qr(SQ, config=cfg(square_method="hr"), **dev),
        "tsqr r": lambda: api.tsqr(TS, "r", cfg(), **dev),
        "tsqr reduced": lambda: api.tsqr(TS, "reduced", cfg(), **dev),
        "tsqr factor": lambda: api.tsqr(TS, "factor", cfg(), **dev),
        "tsqr r cholqr2": lambda: api.tsqr(TS, "r", cfg(), strategy="cholqr2", **dev),
        "tsqr reduced cholqr2": lambda: api.tsqr(TS, "reduced", cfg(), strategy="cholqr2",
                                                 **dev),
        "tsqr reduced chain": lambda: api.tsqr(TS, "reduced", cfg(), strategy="chain", **dev),
        "qr_batched hh": lambda: api.qr_batched(BA, config=cfg(), **dev),
        "qr_batched r": lambda: api.qr_batched(BA, "r", config=cfg(), **dev),
        "qr_batched cholqr2": lambda: api.qr_batched(BA, config=cfg(batched_method="cholqr2"),
                                                     **dev),
    }
    try:
        jax.block_until_ready(calls[name]())
    except ValueError as e:
        return str(e)
    return None


ENTRIES = ["qr hh", "qr hr", "tsqr r", "tsqr reduced", "tsqr factor", "tsqr r cholqr2",
           "tsqr reduced cholqr2", "tsqr reduced chain", "qr_batched hh", "qr_batched r",
           "qr_batched cholqr2"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("mode", ["b3", "b4", "high", "default"])
def test_the_port_raises_where_tileqr_raises(entry, mode):
    """tileqr raises where a plain XLA product (``jnp.dot``/``einsum``)
    receives "b3"/"b4": forming the tree's Q, CholeskyQR2 and
    ``qr_batched``. The port raises ValueError at the same entries,
    naming the mode, and runs everywhere else (ROADMAP.md queue C)."""
    want = _entry(tileqr, entry, mode)
    got = _entry(tileqr_torch, entry, mode, device="cpu")
    assert (got is None) == (want is None), (got, want)
    if got is not None:
        assert mode in got and "Precision" in want


@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_tsqr_apply_runs_the_split_product(mode, trans):
    """``tsqr_apply_q`` in b3/b4 on the SAME tree factors (tileqr's, moved
    over by interop): the leaves' and levels' LARFB products in the mode,
    round-to-nearest split as the reference's XLA-level ``larfb_body``.
    Four dependent products per row block, so the two stay within 1e-5."""
    from tileqr.drivers import tsqr as jtsqr
    from tileqr_torch.drivers import tsqr
    from tileqr_torch.interop import tsqr_factors_from_numpy

    rng = np.random.default_rng(6)
    a = rng.standard_normal((5 * 64, 32)).astype(np.float32)
    c = rng.standard_normal((5 * 64, 7)).astype(np.float32)
    jf = jtsqr.tsqr_factor(jnp.asarray(a), nb=128, interpret=True, leaf_rows=64, arity=4)
    f = tsqr_factors_from_numpy(jf)
    got = tsqr.tsqr_apply_q(f, torch.tensor(c), trans=trans, precision=mode)
    want = jtsqr.tsqr_apply_q(jf, jnp.asarray(c), trans=trans, precision=mode)
    hi = tsqr.tsqr_apply_q(f, torch.tensor(c), trans=trans)
    assert rel(got, want) <= 1e-5 and rel(got, want) < rel(hi, want)

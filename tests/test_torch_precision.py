"""The precision modes of tileqr_torch ("b3", "b4", "default", "high") on
the CPU: the split product and the plain versions of the kernels whose
products follow the mode (K3 ``couple_strip``, K4 ``larfb_strip``, B6
``panel_apply_carry``, B7 ``panel_apply`` and the hr driver's
``_apply_block_t``), against tileqr on the same numpy inputs (JAX on the
CPU, Pallas in interpret mode).

Tolerances, each with its reason:
- the splits: bitwise (the same roundings of the same float32 values);
- "b3"/"b4" in float32: relative Frobenius ≤ 1e-5. Both sides take the
  same bf16 halves and exact bf16×bf16 products; only the fp32 sums run in
  another order (tileqr's CPU run agrees with a numpy split to ~5e-8), and
  one emulated pass differs from another at ~1e-5, so this also tells the
  modes apart;
- float64 in every mode: ≤ 1e-12 against tileqr (the exact product in
  both packages), and bitwise equal to the port's own "highest";
- "default": no tight comparison with tileqr, whose CPU "default" is the
  fp32 product; the port's one-pass product is held to a bf16 emulation
  built here, ≤ 1e-6 (fp32 sums of exact products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tileqr.drivers import square_hr as jsquare_hr
from tileqr.kernels import chain as jchain
from tileqr.kernels import common as jcommon
from tileqr.kernels import larfb as jlarfb
from tileqr.kernels import panel as jpanel
from tileqr.kernels import ssrfb as jssrfb
from tileqr.kernels.panel_apply import panel_apply as jpanel_apply
from tileqr.kernels.panel_apply import panel_apply_carry as jpanel_apply_carry
from tileqr_torch.drivers import square_hr
from tileqr_torch.kernels import _build, chain, common, panel_apply
from tileqr_torch.kernels.larfb import larfb_body
from tileqr_torch.kernels.ssrfb import ssrfb_body

SPLIT_MODES = ("b3", "b4")
ALL_MODES = ("highest", "b3", "b4", "high", "default")
TOL32, TOL64 = 1e-5, 1e-12
MM = (((1,), (0,)), ((), ()))


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def t(x):
    return torch.tensor(np.asarray(x))


def bf16_rn(x):
    """x rounded to the nearest bf16 (ties to even), held in float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def bf16_trunc(x):
    """x with its low 16 bits cleared, held in float32."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def gauss(seed, *shape, dt=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dt)


# --- the split and the product -------------------------------------------


def test_split_bf16_matches_the_reference_split():
    a = gauss(0, 64, 48)
    hi, lo = common.split_bf16(t(a))
    jhi, jlo = jcommon._split_bf16(jnp.asarray(a))
    assert np.array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    assert np.array_equal(lo.numpy(), np.asarray(jlo, np.float32))
    assert np.array_equal(hi.numpy(), bf16_rn(a))
    assert np.array_equal(lo.numpy(), bf16_rn(a - bf16_rn(a)))


def test_split_bf16_trunc_matches_the_reference_mask():
    a = gauss(1, 64, 48)
    hi, lo = common.split_bf16_trunc(t(a))
    jhi, jlo = jcommon._split_bf16_xla(jnp.asarray(a))
    assert np.array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    assert np.array_equal(lo.numpy(), np.asarray(jlo, np.float32))
    assert np.array_equal(hi.numpy(), bf16_trunc(a))
    # the two splits are different roundings of the same sum
    assert not np.array_equal(hi.numpy(), common.split_bf16(t(a))[0].numpy())


@pytest.mark.parametrize("passes", [3, 4])
@pytest.mark.parametrize("split", ["nearest", "trunc"])
def test_dot_bx_matches_the_reference(passes, split):
    """Round to nearest against the in-kernel ``_dot_bx``, truncation
    against the XLA-level ``dot_b3_xla``."""
    a, b = gauss(2, 96, 64), gauss(3, 64, 40)
    if split == "nearest":
        want = jcommon._dot_bx(jnp.asarray(a), jnp.asarray(b), MM, passes)
        got = common.dot_bx(t(a), t(b), passes)
    else:
        want = jcommon.dot_b3_xla(jnp.asarray(a), jnp.asarray(b), MM, passes)
        got = common.dot_bx(t(a), t(b), passes, common.split_bf16_trunc)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert rel(got, want) <= 1e-6
    assert 1e-7 < rel(got, exact) <= 1e-4  # the split ran: not the fp32 product


def test_default_is_one_bf16_product():
    a, b = gauss(4, 96, 64), gauss(5, 64, 40)
    want = bf16_rn(a).astype(np.float64) @ bf16_rn(b).astype(np.float64)
    got = common.dot(t(a), t(b), "default")
    assert rel(got, want) <= 1e-6
    assert rel(got, a.astype(np.float64) @ b.astype(np.float64)) > 1e-4


@pytest.mark.parametrize("mode", ALL_MODES)
def test_float64_is_the_exact_product_in_every_mode(mode):
    a, b = gauss(6, 40, 24, dt=np.float64), gauss(7, 24, 16, dt=np.float64)
    assert torch.equal(common.dot(t(a), t(b), mode), t(a) @ t(b))
    assert torch.equal(common.dot_t(t(a), t(a), mode), t(a).T @ t(a))


def test_high_is_b3_and_names_are_checked():
    a, b = t(gauss(8, 32, 32)), t(gauss(9, 32, 32))
    assert torch.equal(common.dot(a, b, "high"), common.dot(a, b, "b3"))
    assert [common.passes_of(m) for m in ALL_MODES] == [0, 3, 4, 3, 1]
    assert [common.counter_key("panel_apply", m) for m in ALL_MODES] == [
        "panel_apply", "panel_apply[b3]", "panel_apply[b4]", "panel_apply[b3]",
        "panel_apply[default]"]
    with pytest.raises(ValueError, match="precision"):
        common.passes_of("bf16")
    with pytest.raises(ValueError, match="precision"):
        chain.larfb_strip(a, a, a.clone(), 32, precision="fp8")


# --- the single-tile bodies (inside K3/K4) --------------------------------


def _tile(seed, nb, dt):
    """A packed reflector tile, its T and a couple's V2/T2, from tileqr."""
    a = gauss(seed, 3 * nb, 2 * nb, dt=dt)
    k1 = jpanel.panel_factor(jnp.asarray(a), 0, nb, ib=nb // 2, n_couples=2, interpret=True)
    return a, [np.asarray(x) for x in k1]


BODY_CASES = ([(np.float32, m) for m in SPLIT_MODES]
              + [(np.float64, m) for m in ALL_MODES])


@pytest.mark.parametrize("dt,mode", BODY_CASES,
                         ids=[f"{d.__name__}-{m}" for d, m in BODY_CASES])
@pytest.mark.parametrize("trans", [True, False])
def test_larfb_and_ssrfb_bodies_match_the_reference(dt, mode, trans):
    """``larfb_body``/``ssrfb_body`` against tileqr's single-tile kernels
    (B15's ``larfb``/``ssrfb``, interpret mode) in the same mode: the split
    modes in float32, every mode in float64."""
    nb = 32
    a, (_, v_stack, tg, t2) = _tile(10, nb, dt)
    c_top, c_bot = a[:nb, nb:], a[nb : 2 * nb, nb:]
    want = jlarfb.larfb(jnp.asarray(v_stack[0]), jnp.asarray(tg), jnp.asarray(c_top),
                        trans=trans, precision=mode, interpret=True)
    got = larfb_body(t(v_stack[0]), t(tg), t(c_top), trans, mode)
    wt, wb = jssrfb.ssrfb(jnp.asarray(v_stack[1]), jnp.asarray(t2[1]), jnp.asarray(c_top),
                          jnp.asarray(c_bot), trans=trans, precision=mode, interpret=True)
    gt, gb = ssrfb_body(t(v_stack[1]), t(t2[1]), t(c_top), t(c_bot), trans, mode)
    tol = TOL64 if dt is np.float64 else TOL32
    for g, w in ((got, want), (gt, wt), (gb, wb)):
        assert rel(g, w) <= tol, (mode, rel(g, w))
    if dt is np.float64:
        assert torch.equal(got, larfb_body(t(v_stack[0]), t(tg), t(c_top), trans))


# --- K3 and K4 ------------------------------------------------------------


class StripCase:
    """The geometry of tests/test_torch_kernels.py: A (6nb, 3nb), K1 with one
    head couple, K2 with 2 chunk couples of 2nb rows, from tileqr."""

    def __init__(self, nb, dt):
        self.nb, self.dt = nb, dt
        self.a = gauss(nb, 6 * nb, 3 * nb, dt=dt)
        ja = jnp.asarray(self.a)
        self.k1 = [np.asarray(x) for x in jpanel.panel_factor(
            ja, 0, nb, ib=nb // 2, n_couples=1, interpret=True)]
        self.k2 = [np.asarray(x) for x in jchain.panel_chain(
            ja, jnp.asarray(self.k1[0]), 0, nb, 1, 2, 2 * nb, ib=nb // 2, interpret=True)]


@pytest.fixture(scope="module")
def strips():
    return {(nb, dt): StripCase(nb, dt) for nb in (32, 64) for dt in (np.float32, np.float64)}


def _couple(case, fused, trans, reverse, mode, jax_side):
    nb = case.nb
    _, v_stack, tg, _ = case.k1
    _, v_chunks, t2 = case.k2
    larfb = dict(vkk=v_stack[0], tg=tg) if fused else {}
    if jax_side:
        jc, js = jchain.couple_strip(
            jnp.asarray(v_chunks), jnp.asarray(t2), jnp.asarray(case.a),
            jnp.asarray(case.a[:nb, nb:]), 0, 1, 2, 2 * nb, nb, 1, trans=trans,
            reverse=reverse, precision=mode, interpret=True,
            **{k: jnp.asarray(v) for k, v in larfb.items()})
        return np.asarray(js), np.asarray(jc)[2 * nb :]
    c = t(case.a)
    strip = c[:nb, nb:]
    chain.couple_strip(t(v_chunks), t(t2), c, strip, 0, 1, 2, 2 * nb, nb, 1, trans=trans,
                       reverse=reverse, precision=mode, **{k: t(v) for k, v in larfb.items()})
    return strip.numpy(), c.numpy()[2 * nb :]


COUPLE_VARIANTS = [(True, True, False), (True, False, True), (False, True, False)]


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("fused,trans,reverse", COUPLE_VARIANTS,
                         ids=["fused-fwd-trans", "fused-rev", "unfused-fwd-trans"])
def test_couple_strip_modes_match_the_reference(strips, nb, mode, fused, trans, reverse):
    case = strips[(nb, np.float32)]
    got = _couple(case, fused, trans, reverse, mode, False)
    want = _couple(case, fused, trans, reverse, mode, True)
    hi = _couple(case, fused, trans, reverse, "highest", False)
    for g, w, h in zip(got, want, hi):
        assert rel(g, w) <= TOL32, (mode, rel(g, w))
        assert rel(g, w) < rel(g, h)  # nearer the reference's mode than fp32


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_larfb_strip_modes_match_the_reference(strips, nb, mode, trans):
    case = strips[(nb, np.float32)]
    _, v_stack, tg, _ = case.k1
    want = jchain.larfb_strip(jnp.asarray(v_stack[0]), jnp.asarray(tg),
                              jnp.asarray(case.a[:nb, nb:]), nb, trans=trans, precision=mode,
                              interpret=True)
    strip = t(case.a[:nb, nb:])
    chain.larfb_strip(t(v_stack[0]), t(tg), strip, nb, trans=trans, precision=mode)
    assert rel(strip, want) <= TOL32


@pytest.mark.parametrize("mode", ALL_MODES[1:])
def test_update_kernels_float64_exact_in_every_mode(strips, mode):
    """float64: the port's K3 equals its "highest" bitwise, and tileqr's
    K3 in the same mode to 1e-12."""
    case = strips[(32, np.float64)]
    got = _couple(case, True, True, False, mode, False)
    hi = _couple(case, True, True, False, "highest", False)
    want = _couple(case, True, True, False, mode, True)
    for g, h, w in zip(got, hi, want):
        assert np.array_equal(g, h)
        assert rel(g, w) <= TOL64


# --- B6, B7 and the hr apply ----------------------------------------------

NB_HR = 32


@pytest.fixture(scope="module")
def hr_inputs():
    """A float32 1280² carry and the hr factors of its panels 0 (1280 rows:
    B6 sums 4 row blocks of 320) and 1 (1248 rows: B6 and B7 sum 3 row
    blocks of 416), so the Kahan sums run across blocks."""
    carry = gauss(20, 1248 + NB_HR, 1248 + NB_HR)
    out = {"carry": carry}
    for k in (0, 1):
        s = k * NB_HR
        y, tt, _ = jsquare_hr.hr_panel(jnp.asarray(carry[s:, s : s + NB_HR]), interpret=True)
        out[k] = (np.asarray(y), np.asarray(tt))
    return out


@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_carry_modes_match_the_reference(hr_inputs, mode, k, trans):
    carry = hr_inputs["carry"]
    y, tt = hr_inputs[k]
    assert panel_apply._block(carry.shape[0] - k * NB_HR, NB_HR, 512) < 512
    want = np.asarray(jpanel_apply_carry(jnp.asarray(y), jnp.asarray(tt), jnp.asarray(carry),
                                         k=k, nb=NB_HR, trans=trans, precision=mode,
                                         interpret=True))
    c = t(carry)
    panel_apply.panel_apply_carry(t(y), t(tt), c, k, NB_HR, trans=trans, precision=mode)
    hi = t(carry)
    panel_apply.panel_apply_carry(t(y), t(tt), hi, k, NB_HR, trans=trans)
    s = k * NB_HR
    assert np.array_equal(c.numpy()[:, : s + NB_HR], carry[:, : s + NB_HR])
    assert rel(c, want) <= TOL32 and rel(c, want) < rel(hi, want)


@pytest.mark.parametrize("mode", ("highest",) + SPLIT_MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_panel_apply_matches_the_reference_on_a_window(hr_inputs, mode, trans):
    """B7 on a strided window (the orgqr windows are views), in place."""
    carry = hr_inputs["carry"]
    y, tt = hr_inputs[1]
    s = NB_HR
    want = np.asarray(jpanel_apply(jnp.asarray(y), jnp.asarray(tt),
                                   jnp.asarray(carry[s:, 2 * s :]), trans=trans,
                                   precision=mode, interpret=True))
    c = t(carry)
    win = c[s:, 2 * s :]
    assert panel_apply.panel_apply(t(y), t(tt), win, trans=trans, precision=mode) is win
    assert np.array_equal(c.numpy()[:s], carry[:s])
    assert np.array_equal(c.numpy()[:, : 2 * s], carry[:, : 2 * s])
    assert rel(win, want) <= TOL32


@pytest.mark.parametrize("mode", ALL_MODES)
def test_panel_apply_float64_is_the_formula_in_every_mode(hr_inputs, mode):
    """float64 (tileqr's B6/B7 refuse it: their Kahan scratch is float32)."""
    carry = hr_inputs["carry"].astype(np.float64)
    y, tt = (x.astype(np.float64) for x in hr_inputs[0])
    want = carry - y @ (tt.T @ (y.T @ carry))
    c = t(carry)
    panel_apply.panel_apply(t(y), t(tt), c, trans=True, precision=mode)
    assert rel(c, want) <= TOL64


def test_panel_apply_rejects_bad_shapes():
    y, tt = torch.zeros(64, 32), torch.zeros(32, 32)
    with pytest.raises(ValueError):  # rows differ
        panel_apply.panel_apply(y, tt, torch.zeros(96, 32))
    with pytest.raises(ValueError):  # columns not a multiple of nb
        panel_apply.panel_apply(y, tt, torch.zeros(64, 40))
    with pytest.raises(ValueError):  # T not nb × nb
        panel_apply.panel_apply(y, torch.zeros(16, 16), torch.zeros(64, 32))


@pytest.mark.parametrize("route,cols", [("B7", 64), ("truncating split", 3)])
@pytest.mark.parametrize("mode", SPLIT_MODES)
@pytest.mark.parametrize("trans", [True, False])
def test_apply_block_t_modes_match_the_reference(hr_inputs, route, cols, mode, trans):
    """The hr apply's two emulated routes: nb-aligned targets through B7,
    the rest through the three products with the truncating split, as
    tileqr's ``_apply_block_t`` takes ``panel_apply``/``dot_b3_xla``."""
    y, tt = hr_inputs[0]
    c = gauss(21, y.shape[0], cols)
    want = np.asarray(jsquare_hr._apply_block_t(jnp.asarray(y), jnp.asarray(tt),
                                                jnp.asarray(c), mode, jnp.float32,
                                                trans=trans, interpret=True))
    _build.reset_counts()
    cc = t(c)
    assert square_hr._apply_block_t(t(y), t(tt), cc, trans, mode) is cc
    assert _build.PLAIN_CALLS[f"panel_apply[{mode}]"] == (1 if route == "B7" else 0)
    assert rel(cc, want) <= TOL32
    if route != "B7":  # the reference's split, not the in-kernel one
        p = common.passes_of(mode)
        yy, cn = t(y), t(c)
        tm = t(tt).T if trans else t(tt)
        near = cn - common.dot_bx(yy, common.dot_bx(tm, common.dot_bx(yy.T, cn, p), p), p)
        assert rel(cc, want) < rel(near, want) / 2


@pytest.mark.parametrize("mode", ["high", "default"])
@pytest.mark.parametrize("trans", [True, False])
def test_apply_block_t_ragged_high_and_default_round_to_nearest(hr_inputs, mode, trans):
    """A target no kernel takes (3 columns) in "high" or "default": the three
    products with the round-to-nearest split of the TPU's HIGH and DEFAULT,
    which the reference's ``_dot`` hands these modes to (3 and 1 bf16
    passes), bitwise; not the truncating split it keeps for b3/b4."""
    y, tt = (t(x) for x in hr_inputs[0])
    c = t(gauss(22, y.shape[0], 3))
    tm = tt.T if trans else tt
    p = common.passes_of(mode)

    def three(split):
        w = common.dot_bx(tm, common.dot_bx(y.T, c, p, split), p, split)
        return c - common.dot_bx(y, w, p, split)

    _build.reset_counts()
    got = square_hr._apply_block_t(y, tt, c.clone(), trans, mode)
    assert not any(_build.PLAIN_CALLS.values())
    assert torch.equal(got, three(common.split_bf16))
    assert not torch.equal(got, three(common.split_bf16_trunc))


@pytest.fixture(scope="module")
def odd_panels():
    """hr factors of panels nb = 40 (not a multiple of 32) and nb = 264
    (wider than the fp32 B7 takes), and a target of 2·nb columns."""
    out = {}
    for nb in (40, 264):
        m = 2 * nb if nb > 256 else 32 * nb
        a = gauss(nb, m, 3 * nb)
        y, tt, _ = jsquare_hr.hr_panel(jnp.asarray(a[:, :nb]), interpret=True)
        out[nb] = (np.asarray(y), np.asarray(tt), a[:, nb:])
    return out


@pytest.mark.parametrize("nb", [40, 264])
@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_apply_block_t_routes_by_alignment_alone(odd_panels, nb, mode):
    """An nb-aligned target in b3/b4 goes to B7 whatever nb is, as the
    reference sends it to its Pallas ``panel_apply``: the same result to
    1e-5, and B7's plain version ran once (its kernel on the card)."""
    y, tt, c = odd_panels[nb]
    want = np.asarray(jsquare_hr._apply_block_t(jnp.asarray(y), jnp.asarray(tt),
                                                jnp.asarray(c), mode, jnp.float32,
                                                trans=True, interpret=True))
    _build.reset_counts()
    got = square_hr._apply_block_t(t(y), t(tt), t(c), True, mode)
    assert _build.PLAIN_CALLS[f"panel_apply[{mode}]"] == 1
    assert rel(got, want) <= TOL32
    assert panel_apply.kernel_takes(nb, mode) and not panel_apply.kernel_takes(nb)

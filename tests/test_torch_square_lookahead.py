"""The hh driver's lookahead on the CPU: ``qr_tiled`` splits update k into
the narrow update of column tile k+1 and the rest, and factors panel k+1
between them. Here everything runs on one stream in that order, so these
tests hold the split's algebra to the unsplit loop (the driver before the
lookahead, copied below) and count the splits."""

import numpy as np
import pytest
import torch

import tileqr_torch as tq
from tileqr_torch.core import trace
from tileqr_torch.drivers.square import _chunk_for, _segments, qr_tiled
from tileqr_torch.kernels import _build
from tileqr_torch.kernels.chain import couple_strip, larfb_strip, panel_column


def unsplit_qr_tiled(a, nb, ib=128, chunk=4, precision="highest"):
    """The right-looking loop with one update call a panel, over every
    trailing column, before the next panel."""
    m, n = a.shape
    mt, nt = m // nb, n // nb
    c = _chunk_for(mt, chunk)
    r_diag, t_geqrt, panels = [], [], []
    for k in range(min(mt, nt)):
        n_head, base, nc = _segments(k, mt, c)
        r_k, v_stack, tg_k, t2h, v_chunks, t2t = panel_column(a, k, nb, ib, n_head, base,
                                                              nc, c * nb)
        r_diag.append(r_k)
        t_geqrt.append(tg_k)
        panels.append((v_stack, t2h, v_chunks, t2t))
        if nt - k - 1 == 0:
            continue
        strip = a[k * nb : (k + 1) * nb, (k + 1) * nb :]
        mode = dict(trans=True, precision=precision)
        if n_head > 0:
            couple_strip(v_stack, t2h, a, strip, 1, k + 1, n_head, nb, nb, k + 1,
                         vkk=v_stack[0], tg=tg_k, **mode)
            if nc > 0:
                couple_strip(v_chunks, t2t, a, strip, 0, base, nc, c * nb, nb, k + 1, **mode)
        elif nc > 0:
            couple_strip(v_chunks, t2t, a, strip, 0, base, nc, c * nb, nb, k + 1,
                         vkk=v_stack[0], tg=tg_k, **mode)
        else:
            larfb_strip(v_stack[0], tg_k, strip, nb, **mode)
    return a, torch.stack(r_diag), torch.stack(t_geqrt), tuple(panels)


# (m, n, chunk) at nb = 32: head couples (chunk 4 leaves most panels a
# head), chunks only (chunk 1), tall, wide, and nt = 2 (nothing to split)
SHAPES = {"head": (256, 256, 4), "chunks": (256, 256, 1), "tall": (384, 160, 4),
          "wide": (128, 320, 2), "nt2": (192, 64, 2)}
NB, IB = 32, 16
# float64: the same algebra, summed over other column sets; float32 to the
# relerr of tests/test_torch_square.py's reconstruction
TOLS = {torch.float64: 1e-12, torch.float32: 2e-6}


def _flat(f):
    return [f[0], f[1], f[2]] + [x for p in f[3] for x in p]


def _rel(x, y):
    return float(torch.linalg.norm((x - y).double())
                 / max(float(torch.linalg.norm(y.double())), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_updates_match_the_unsplit_loop(shape, dtype):
    m, n, chunk = SHAPES[shape]
    a = torch.from_numpy(np.random.default_rng(m * n + chunk).standard_normal((m, n))).to(dtype)
    got = qr_tiled(a.clone(), NB, ib=IB, chunk=chunk)
    want = unsplit_qr_tiled(a.clone(), NB, ib=IB, chunk=chunk)
    assert len(got[3]) == len(want[3])
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape and _rel(g, w) <= TOLS[dtype]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_lookahead_counts_the_split_updates(shape):
    """split = max(0, min(mt, nt - 2)): every panel with two or more
    column tiles to update; nothing runs beside on the CPU."""
    m, n, chunk = SHAPES[shape]
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((m, n), dtype=np.float32))
    _build.reset_counts()
    qr_tiled(a, NB, ib=IB, chunk=chunk)
    mt, nt = m // NB, n // NB
    assert trace.LOOKAHEAD == {"split": max(0, min(mt, nt - 2)), "beside": 0}
    _build.reset_counts()
    assert trace.LOOKAHEAD == {"split": 0, "beside": 0}


def test_lookahead_counts_through_the_api():
    """qr at 256², nb 64 (4 panels) splits updates 0 and 1; tsqr's chain
    runs the driver on one panel and splits nothing."""
    a = torch.from_numpy(np.random.default_rng(4).standard_normal((256, 256), dtype=np.float32))
    _build.reset_counts()
    q, r = tq.qr(a, config=tq.QRConfig(nb=64, ib=32, chunk=2))
    assert trace.LOOKAHEAD == {"split": 2, "beside": 0}
    assert float(torch.linalg.norm(a - q @ r) / torch.linalg.norm(a)) < 2e-6
    _build.reset_counts()
    tq.tsqr(a[:, :64].contiguous(), "r", tq.QRConfig(nb=64, ib=32), strategy="chain")
    assert trace.LOOKAHEAD == {"split": 0, "beside": 0}

"""``tileqr_torch.tsqr(a, "factor")`` returning whole-panel compact-WY
factors (CholeskyQR2's ``HRFactors``): Y (m, k), T (k, k) and R (k, n),
with Q = I − Y·T·Yᵀ. Any other factors (the tree's) are refused as a
wrong answer."""

import torch

from qrbench import judge, lawn41

BACKWARD = "resid"


def make(tq, cfg, args):
    return lambda a: tq.tsqr(a, "factor", cfg, **args)


def answer(out):
    panels = getattr(out, "panels", None)
    if panels is None or len(panels) != 1 or len(panels[0]) != 2:
        raise ValueError(f"{type(out).__name__} is not one whole-panel (Y, T) pair")
    y, t = panels[0]
    m, n = out.shape
    return y, t, out.r[:min(m, n), :n] * out.scale


def flops(shape):
    m, n = shape
    return lawn41.geqrf(m, n)


def least_bytes(shape, itemsize):
    m, n = shape
    k = min(m, n)
    return float(itemsize * (m * n + m * k + k * k + k * n))


def truth(ref, a):
    return ref.qr(a).r


def numbers(a, ans, r_ref):
    y, t, r = ans
    m, n = a.shape
    k = min(m, n)
    judge.check_shape("Y", y, (m, k))
    judge.check_shape("T", t, (k, k))
    judge.check_shape("R", r, (k, n))
    return {"r_gap": judge.r_gap(r, r_ref), "resid": judge.resid_wy(a, y, t, r),
            "orth": judge.orth_wy(y, t)}


def reference(ref, a, precision):
    f = ref.qr(a, dtype=torch.float32, precision=precision, keep=True)
    y, t = ref.wy(f, precision)
    return y, t, f.r

"""``tileqr_torch.qr(a, mode="reduced")``: Q (m, k) and R (k, n)."""

import torch

from qrbench import judge, lawn41

BACKWARD = "resid"


def make(tq, cfg, args):
    return lambda a: tq.qr(a, mode="reduced", config=cfg, **args)


def answer(out):
    return out


def flops(shape):
    m, n = shape
    k = min(m, n)
    return lawn41.geqrf(m, n) + lawn41.orgqr(m, k, k)


def least_bytes(shape, itemsize):
    m, n = shape
    k = min(m, n)
    return float(itemsize * (m * n + m * k + k * n))


def truth(ref, a):
    return ref.qr(a).r


def numbers(a, ans, r_ref):
    q, r = ans
    m, n = a.shape
    k = min(m, n)
    judge.check_shape("Q", q, (m, k))
    judge.check_shape("R", r, (k, n))
    return {"r_gap": judge.r_gap(r, r_ref), "resid": judge.resid_qr(a, q, r),
            "orth": judge.orth_q(q)}


def reference(ref, a, precision):
    f = ref.qr(a, dtype=torch.float32, precision=precision, keep=True)
    return ref.form_q(f, precision), f.r

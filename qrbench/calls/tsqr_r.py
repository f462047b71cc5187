"""``tileqr_torch.tsqr(a, "r")``: R (n, n) alone."""

import torch

from qrbench import judge, lawn41

BACKWARD = "gram_resid"


def make(tq, cfg, args):
    return lambda a: tq.tsqr(a, "r", cfg, **args)


def answer(out):
    return out


def flops(shape):
    m, n = shape
    return lawn41.geqrf(m, n)


def least_bytes(shape, itemsize):
    m, n = shape
    k = min(m, n)
    return float(itemsize * (m * n + k * n))


def truth(ref, a):
    return ref.qr(a).r


def numbers(a, r, r_ref):
    m, n = a.shape
    judge.check_shape("R", r, (min(m, n), n))
    return {"r_gap": judge.r_gap(r, r_ref), "gram_resid": judge.gram_resid(a, r)}


def reference(ref, a, precision):
    return ref.qr(a, dtype=torch.float32, precision=precision).r

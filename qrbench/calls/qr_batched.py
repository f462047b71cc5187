"""``tileqr_torch.qr_batched(a, mode="reduced")`` on a (B, m, n) stack:
Q (B, m, n) and R (B, n, n). Every member is a caller's answer, so each
number is the largest over the B members, computed in float64 in blocks of
members so that it fits beside the program's state."""

import dataclasses

import torch

from qrbench import judge, lawn41

BACKWARD = "resid"
F64 = judge.F64


def make(tq, cfg, args):
    cfg = dataclasses.replace(cfg, **args)
    return lambda a: tq.qr_batched(a, mode="reduced", config=cfg)


def answer(out):
    return out


def flops(shape):
    b, m, n = shape
    return b * (lawn41.geqrf(m, n) + lawn41.orgqr(m, n, n))


def least_bytes(shape, itemsize):
    b, m, n = shape
    return float(itemsize * b * (2 * m * n + n * n))


def truth(ref, a):
    return ref.qr(a).r


def _members(m: int, n: int) -> int:
    """Members a block: 2^25 float64 elements (256 MiB) an (m, n) operand."""
    return max(1, (1 << 25) // (m * n))


def numbers(a, ans, r_ref):
    """r_gap ‖D·R − R_ref‖F/‖R_ref‖F (D the signs that make the diagonals
    agree), resid ‖A − QR‖F/‖A‖F and orth ‖QᵀQ − I‖F, each member's, the
    largest of the stack (NaN where any member's is)."""
    q, r = ans
    b, m, n = a.shape
    judge.check_shape("Q", q, (b, m, n))
    judge.check_shape("R", r, (b, n, n))
    eye = torch.eye(n, dtype=F64, device=a.device)
    fro = lambda x: torch.linalg.norm(x, dim=(-2, -1))  # noqa: E731
    worst = {"r_gap": [], "resid": [], "orth": []}
    step = _members(m, n)
    for i in range(0, b, step):
        a64, q64, r64, rr = (x[i:i + step].to(F64) for x in (a, q, r, r_ref))
        d = torch.sign(torch.diagonal(r64, dim1=-2, dim2=-1)) * torch.sign(
            torch.diagonal(rr, dim1=-2, dim2=-1))
        d = torch.where(d == 0, torch.ones_like(d), d)
        worst["r_gap"].append(fro(d[..., None] * r64 - rr) / fro(rr))
        worst["resid"].append(fro(a64 - q64 @ r64) / fro(a64))
        worst["orth"].append(fro(q64.mT @ q64 - eye))
    return {k: float(torch.cat(v).max()) for k, v in worst.items()}


def reference(ref, a, precision):
    f = ref.qr(a, dtype=torch.float32, precision=precision, keep=True)
    return ref.form_q(f, precision), f.r

"""The yardstick's arithmetic: LAPACK flop counts (LAPACK Working Note 41)
and the card's published peaks. Each call module (``calls/``) counts its
call's flops and least bytes from these.

Frozen here so that it cannot move with the program: the flop count and
the peaks are the ones ``chip_smoke.py`` uses (``geqrf_flops``,
``PEAK_FLOPS``, ``PEAK_BYTES``). The counts are of the work a call asks
for, whatever algorithm the program runs for it.
"""

from __future__ import annotations

# NVIDIA H100 SXM: fp32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def geqrf(m: int, n: int) -> float:
    """Householder QR of an (m, n) matrix."""
    if m < n:
        return 2.0 * n * m * m - 2.0 * m ** 3 / 3.0
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0


def orgqr(m: int, n: int, k: int) -> float:
    """Forming the first n columns of Q (m, n) from k reflectors."""
    return 4.0 * m * n * k - 2.0 * (m + n) * k * k + 4.0 * k ** 3 / 3.0


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the flops at the
    fp32 peak and the bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)

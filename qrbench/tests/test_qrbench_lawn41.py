"""The yardstick's counts against the numbers the cells are defined with."""

import pytest

from qrbench import lawn41, spec


def test_square_qr_counts_geqrf_and_orgqr():
    n = 8192
    qr = spec.load("calls", "qr_reduced")
    assert qr.flops((n, n)) == pytest.approx(8 * n**3 / 3)
    assert qr.flops((n, n)) == pytest.approx(1.4660e12, rel=1e-4)
    assert lawn41.geqrf(n, n) == pytest.approx(lawn41.orgqr(n, n, n))


def test_tall_counts_geqrf_only():
    for name in ("tsqr_r", "tsqr_factor"):
        assert spec.load("calls", name).flops((1048576, 512)) == pytest.approx(5.4967e11, rel=1e-4)
    assert lawn41.geqrf(512, 1048576) == lawn41.geqrf(1048576, 512)


def test_orgqr_matches_lawn41():
    m, n, k = 1000, 300, 200
    assert lawn41.orgqr(m, n, k) == 4 * m * n * k - 2 * (m + n) * k**2 + 4 * k**3 / 3


def test_least_bytes_and_time():
    m, n = 1048576, 512
    assert spec.load("calls", "tsqr_r").least_bytes((m, n), 4) == 4 * (m * n + n * n)
    assert spec.load("calls", "tsqr_factor").least_bytes((m, n), 4) == 4 * (2 * m * n + 2 * n * n)
    assert spec.load("calls", "qr_reduced").least_bytes((n, n), 4) == 4 * 3 * n * n
    flops = spec.load("calls", "tsqr_r").flops((m, n))
    assert lawn41.least_seconds(flops, 1.0) == flops / 67e12
    assert lawn41.least_seconds(1.0, 3.35e12) == 1.0

"""backward_error: the largest float64 backward error among the judged
answers, the number that the cell's call module names (``BACKWARD``:
‖A − QR‖F/‖A‖F, ‖QᵀA − R‖F/‖A‖F or ‖AᵀA − RᵀR‖F/‖A‖F²). The harness
computes it itself after the window; it is no time. ``BENCHMARK.json``
labels it ``host_clock`` because the contract's sources for an end-to-end
metric are ``host_clock`` and ``device_trace`` alone."""

import math


def read(rec):
    v = rec.backward_error
    return v if v is not None and math.isfinite(v) else None

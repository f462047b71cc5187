"""kernel_roofline_pct: the calls' least time (``lawn41.least_seconds``: the
LAPACK flops at the fp32 peak or the least bytes at the HBM rate, the
larger) over the device's busy time for them, in percent."""


def read(rec):
    t = rec.trace
    if not t or not t.get("n_calls") or not t.get("busy_s"):
        return None
    return 100.0 * rec.least_s * t["n_calls"] / t["busy_s"]

"""device_idle_pct: the share of the traced window of whole calls in which
no device operation runs (one minus the union of their intervals)."""


def read(rec):
    t = rec.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

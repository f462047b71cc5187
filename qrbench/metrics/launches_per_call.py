"""launches_per_call: device operations (kernels, copies, sets) per call,
counted from the profiler's trace of whole calls."""


def read(rec):
    t = rec.trace
    if not t or not t.get("n_calls") or not t.get("n_ops"):
        return None
    return t["n_ops"] / t["n_calls"]

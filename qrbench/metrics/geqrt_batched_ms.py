"""geqrt_batched_ms: the device ms a traced call spends in the batched
GEQRT, on any of its routes: the breakdown's ``device_ops`` groups whose
name starts with "geqrt_batched" (``trace.OWN``: the one-block kernel, the
cluster, small and tall routes), over the traced calls. None where the
trace holds no device operation or no such group."""

GROUP = "geqrt_batched"


def read(rec):
    t = rec.trace
    if not t or not t.get("n_calls") or not t.get("n_ops"):
        return None
    got = [s for name, s in t["breakdown"]["device_ops"] if name.startswith(GROUP)]
    if not got:
        return None
    return 1e3 * sum(got) / t["n_calls"]

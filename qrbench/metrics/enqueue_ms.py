"""enqueue_ms: the mean host time from a call's entry to its return, before
the benchmark's synchronize (the benchmark's own span around the API)."""


def read(rec):
    spans = [(c[1] - c[0]) * 1e3 for c in rec.calls if c[3]]
    return sum(spans) / len(spans) if spans else None

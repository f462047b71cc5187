"""call_p90_ms: the 90th percentile (nearest rank) of every call's wall time
in the window, from the call to the end of its synchronize; a failed call
counts as missing every limit."""

import math


def read(rec):
    times = sorted((c[2] - c[0]) * 1e3 if c[3] else math.inf for c in rec.calls)
    if not times:
        return None
    v = times[math.ceil(0.9 * len(times)) - 1]
    return v if math.isfinite(v) else None

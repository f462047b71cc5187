"""panel_apply_ms: the device ms a traced call spends in the whole-panel
apply, B6 (the hr trailing update) and B7 (Q's formation on the wide
windows): the breakdown's ``device_ops`` groups whose name starts with
"panel apply B6/B7" (``trace.OWN``: phase 1, in fp32 or split, and its
groups' combine) or with "C -= Y W" (phase 2, which K3's stage 3 shares:
in a cell that launches no K3 it is B6/B7's alone), over the traced
calls. None where the trace holds no device operation or no such group."""

GROUPS = ("panel apply B6/B7", "C -= Y W")


def read(rec):
    t = rec.trace
    if not t or not t.get("n_calls") or not t.get("n_ops"):
        return None
    got = [s for name, s in t["breakdown"]["device_ops"] if name.startswith(GROUPS)]
    if not got:
        return None
    return 1e3 * sum(got) / t["n_calls"]

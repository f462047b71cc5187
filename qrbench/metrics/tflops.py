"""tflops: the LAPACK flops of every call completed in the window, over the
window's seconds on the host clock."""


def read(rec):
    done = sum(1 for c in rec.calls if c[3])
    if not done or rec.window_s <= 0:
        return None
    return done * rec.flops_per_call / rec.window_s / 1e12

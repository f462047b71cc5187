"""setup_s: from the run's start to the window's: imports, the CUDA
context, loading (or building) the kernel library, the inputs and the warm
calls."""


def read(rec):
    return rec.setup_s

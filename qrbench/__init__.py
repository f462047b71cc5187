"""The benchmark of tileqr_torch, the PyTorch and CUDA port of tileqr.

``python3 -m qrbench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1``
runs one cell of ``BENCHMARK.json`` once (``run.py``). Every configuration,
traffic mix, call, input distribution, limit file, reference and metric
reader is a file of its own, found by name (``spec.py``). Nothing here
imports JAX or the JAX package, and the reference imports nothing of the
program.
"""

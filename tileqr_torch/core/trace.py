"""Named spans of the port's phases, on torch.profiler's own clock.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
is recording and a shared no-op otherwise: the check costs about a
microsecond, a ``record_function`` with no profiler running about ten.
So spans show up whenever someone profiles, beside the device operations
their phase launched, and there is no switch to set. ``SPANS`` names them
all; ``utils/profile.py:span_times`` charges device time to them.

``GUARD`` counts the CholeskyQR breakdown guard's host checks and trips
(``drivers/cholqr.py:guard_falls_back``) by call site, whether or not a
profiler runs. ``LOOKAHEAD`` counts the hh driver's updates split in two
for its lookahead (``drivers/square.py:qr_tiled``; on any device) and the
panel launches enqueued on its side stream beside a rest update (the card
only). ``HR_APPLY`` counts the route that each block-reflector apply of
the hr square path took (``drivers/square_hr.py:_apply_block_t``; on any
device). ``kernels/_build.py:reset_counts`` clears all three.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch

ENTRIES = tuple(f"tileqr_torch.{e}" for e in
                ("qr", "qr_factor", "orgqr", "apply_q", "lstsq", "tsqr", "qr_batched"))
SYNCS = tuple(f"tileqr_torch.sync.{s}" for s in ("guard", "tree_index", "tall_ops", "upload"))
SPANS = ENTRIES + tuple(f"tileqr_torch.{p}" for p in (
    "prep", "assemble_r", "hh.panel", "hh.update", "tree.leaves", "tree.level",
    "hr.round1", "hr.round2", "hr.reconstruct", "hr.update", "hr.apply", "batched.geqrt",
    "batched.form_q")) + SYNCS

# {call site: {"checks": n, "trips": n}} of the breakdown guard
GUARD: Dict[str, Dict[str, int]] = {}
# the hh driver's lookahead: updates split in two, panels launched beside a rest
LOOKAHEAD = {"split": 0, "beside": 0}
# the hr square path's block-reflector applies by route: B7 ("b7"), W by
# pairwise row sums ("pair"), by split-K ("splitk"), by one product ("one"),
# or the three products in an emulated mode's plain torch ("emulated")
HR_APPLY = {"b7": 0, "pair": 0, "splitk": 0, "one": 0, "emulated": 0}

_OFF = contextlib.nullcontext()


def count_guard(where: str, tripped: bool) -> None:
    """One host check of the guard at ``where``, and whether it tripped."""
    site = GUARD.setdefault(where, {"checks": 0, "trips": 0})
    site["checks"] += 1
    site["trips"] += int(tripped)


def span(name: str):
    """A context that records ``name`` as a span while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def entry(name: str):
    """Decorator: the whole call of a public entry as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap

"""Named spans of the port's phases, on torch.profiler's own clock.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
is recording and a shared no-op otherwise: the check costs about a
microsecond, a ``record_function`` with no profiler running about ten.
So spans show up whenever someone profiles, beside the device operations
their phase launched, and there is no switch to set. ``SPANS`` names them
all; ``utils/profile.py:span_times`` charges device time to them.
"""

from __future__ import annotations

import contextlib
import functools

import torch

ENTRIES = tuple(f"tileqr_torch.{e}" for e in
                ("qr", "qr_factor", "orgqr", "apply_q", "lstsq", "tsqr", "qr_batched"))
SYNCS = tuple(f"tileqr_torch.sync.{s}" for s in ("guard", "tree_index", "tall_ops", "upload"))
SPANS = ENTRIES + tuple(f"tileqr_torch.{p}" for p in (
    "prep", "assemble_r", "hh.panel", "hh.update", "tree.leaves", "tree.level",
    "hr.round1", "hr.round2", "hr.reconstruct")) + SYNCS

_OFF = contextlib.nullcontext()


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

"""Per-call readings of the port's own trace log
(``thermoextrap_tpu_torch.utils.trace``) over the traced slice.

The port records while a profiler runs, and the harness runs one only over
the slice and the bare kernel entries of the roofline readers, which log
nothing (a span outside a public call is not kept).  So the log holds the
slice's calls: a stream's call is two of them, an update and a predict.  A
reading sums over the logged calls and divides by the benchmark calls in
the slice.  It is None without a slice, or where the port logged nothing
(a program without the log reads None too).
"""

from __future__ import annotations

import importlib


def _logged_calls() -> list:
    try:
        trace = importlib.import_module("thermoextrap_tpu_torch.utils.trace")
    except ImportError:
        return []
    return trace.calls()


def per_call(ctx, measure) -> float | None:
    """``measure(logged call)`` summed over the log, per call of the slice."""
    s = ctx.slice
    logged = _logged_calls() if s is not None and s.calls else []
    if not logged:
        return None
    return sum(measure(c) for c in logged) / s.calls


def span_ms(names):
    """A logged call's host milliseconds in the spans ``names``."""
    return lambda c: sum(t1 - t0 for _id, _parent, name, t0, t1 in c["spans"] if name in names) * 1e-6


def counter(name: str):
    """A logged call's delta of the counter ``name``."""
    return lambda c: sum(c["counters"].get(name, {}).values())

"""Spans and counters of the port's calls, on ``torch.profiler``'s clock.

Recording follows the profiler.  While a ``torch.profiler.profile`` runs,
:func:`span` enters ``torch.autograd.profiler.record_function(name)``, so
the span lands in the profiler's trace beside the device activities, on
the same clock; a span inside a :func:`call` is also kept in a bounded
in-memory log (:func:`calls`), timed by ``time.perf_counter_ns``.  With no
profiler running, a span or a call costs one check of
``torch.autograd._profiler_enabled()``: it enters no ``record_function``,
adds no CUDA event and no synchronize, and writes nothing.

Spans time the host only; the device side of a stage is read from the
profiler's trace.  The stack of open spans is per thread.  A :func:`call`
is the top-level span of one public call: it opens a new call id, and every
span inside it is logged with that id and its parent span's name.  A call
opened inside another call is a stage of the outer one; a span opened
outside any call reaches the profiler only.

The pipelines' and models' spans:

=====================================  =====  =================================================
name                                   kind   covers
=====================================  =====  =================================================
``te.extrap``                          call   ``make_extrap_pipeline``'s ``run``
``te.lnpi``                            call   ``make_lnpi_pipeline``'s ``run``
``te.stream.update``,                  call   ``make_streaming_extrap_pipeline``'s ``update``
``te.stream.predict``                         and ``predict``
``te.mbar``                            call   ``models.extrap.MBARModel.predict``
``te.reduce``                          stage  ``ops.dispatch.reduce_central`` / ``reduce_central_u``
``te.boot``                            stage  the K3 / K5 bootstrap, or the CPU route's table one
``te.coefs``                           stage  the float64 casts and the series coefficients
``te.taylor``                          stage  the Taylor evaluation and the replicates' std
``te.merge``                           stage  ``DataCentralMoments.merge``
``te.mbar.pool``                       stage  the stacking of the states' samples, the α copies
``te.mbar.solve``                      stage  ``u_kn`` and ``models.mbar.mbar_solve``
``te.mbar.grid``                       stage  ``models.mbar.mbar_expectations_alphas``
``te.sync``                            stage  a host wait counted in ``host_syncs``
=====================================  =====  =================================================

:data:`COUNTERS` holds the port's counters by reference under one name each:
``launches`` (``ops.moments_cuda.LAUNCHES``), ``host_reads``
(``utils.device.HOST_READS``), ``host_syncs``
(``utils.device.HOST_SYNCS``: each point where the program makes the host
wait on the card, a read back or a blocking copy of host data onto a CUDA
device) and, once ``models.mbar`` is imported, ``mbar_iters``
(``models.mbar.MBAR_ITERS``: the MBAR solver's iterations).  A logged call
carries the deltas of every counter over it.

>>> from torch.profiler import profile
>>> with profile() as prof:
...     with call("demo"):
...         with span("demo.stage"):
...             pass
>>> rec = calls()[-1]
>>> rec["name"], [s[1:3] for s in rec["spans"]]
('demo', [('demo', 'demo.stage')])
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd.profiler import record_function

__all__ = ["COUNTERS", "MAX_CALLS", "MAX_SPANS", "call", "calls", "register", "span"]

MAX_CALLS = 1024  # calls kept in the log, the newest
MAX_SPANS = 1024  # spans kept a call, the first

# counter name -> its dict of counts, held by reference
COUNTERS: dict[str, dict] = {}

_LOG: collections.deque = collections.deque(maxlen=MAX_CALLS)
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .stack: the names of the open spans; .call: the open call's record
_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def register(name: str, counts: dict) -> dict:
    """Hold ``counts`` (a dict of integer counts) under ``name``."""
    COUNTERS[name] = counts
    return counts


def _local():
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
        _LOCAL.call = None
    return _LOCAL


class _Span:
    __slots__ = ("_call", "_parent", "_rf", "_t0", "name")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _local()
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._parent = local.stack[-1] if local.stack else None
        self._call = local.call
        local.stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _LOCAL.stack.pop()
        rec = self._call
        if rec is not None and len(rec["spans"]) < MAX_SPANS:
            rec["spans"].append((rec["id"], self._parent, self.name, self._t0, t1))
        self._rf.__exit__(*exc)
        return False


class _Call(_Span):
    __slots__ = ("_before",)

    def __enter__(self):
        local = _local()
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._before = {k: dict(v) for k, v in COUNTERS.items()}
        self._call = local.call = {"id": next(_IDS), "name": self.name, "spans": []}
        local.stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _LOCAL.stack.pop()
        _LOCAL.call = None
        rec = self._call
        rec["t0_ns"], rec["t1_ns"] = self._t0, t1
        rec["counters"] = {
            k: {n: c - self._before.get(k, {}).get(n, 0) for n, c in v.items()} for k, v in COUNTERS.items()
        }
        _LOG.append(rec)
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the stage ``name`` while a profiler runs, else
    nothing."""
    if not _enabled():
        return _OFF
    return _Span(name)


def call(name: str):
    """A context manager: the public call ``name`` (a stage where a call is
    already open on this thread) while a profiler runs, else nothing."""
    if not _enabled():
        return _OFF
    return _Call(name) if getattr(_LOCAL, "call", None) is None else _Span(name)


def calls() -> list[dict]:
    """The logged calls, oldest first: each a dict of ``id``, ``name``,
    ``t0_ns``, ``t1_ns``, ``spans`` (``(call id, parent, name, t0_ns,
    t1_ns)`` tuples in the order they closed) and ``counters`` (each
    counter's deltas over the call)."""
    return list(_LOG)

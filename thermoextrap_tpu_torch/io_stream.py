"""Prefetching ingest runtime: overlap file reads and parsing with device work.

Counterpart of ``thermoextrap_tpu/io_stream.py``: the data-loader runtime
around the streaming pipelines.  A bounded-depth prefetcher loads chunks
(the C++ :func:`.native.loadtxt_fast` for text tables, ``np.load`` for
``.npy`` files) on a worker thread, optionally stages them onto a device
ahead of use, and hands the consumer a plain iterator, so that the
``update`` of :func:`.pipeline.make_streaming_extrap_pipeline` (K1 and K3
on the card) runs while the next chunk is read and copied.

Staging onto a CUDA device happens on a stream of the worker's own: each
array is copied from pinned host memory with ``non_blocking=True`` on that
stream and an event is recorded after the copies; before the consumer gets
the chunk, its current stream waits on the event and every tensor is
``record_stream``-ed on it, so the chunk is neither read before its copy
lands nor its memory reused while the consumer's kernels still read it.
No step synchronizes the host.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

__all__ = [
    "ingest_stream",
    "prefetch_chunks",
    "read_npy_chunks",
    "read_table_chunks",
]

_END = ("end", None)


def _map_arrays(item, fn):
    """Apply ``fn`` to the array leaves of a chunk (an array, a tensor, or a
    tuple or list of them); other leaves pass unchanged."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(i, fn) for i in item)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


def _tensors(item):
    if isinstance(item, (tuple, list)):
        return [t for i in item for t in _tensors(i)]
    return [item] if isinstance(item, torch.Tensor) else []


def _pinned(a):
    """A host array or CPU tensor as a pinned CPU tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.contiguous().pin_memory()


def _stager(device):
    """``(stage, hand_over)``: ``stage`` runs on the worker and returns what
    the queue carries; ``hand_over`` runs on the consumer and returns the
    chunk."""
    device = torch.device(device)
    if device.type != "cuda":

        def to_device(a):
            t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            return t.to(device)

        return (lambda item: _map_arrays(item, to_device)), (lambda staged: staged)

    side = torch.cuda.Stream(device=device)

    def copy(a):
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.to(device, non_blocking=True)
        return _pinned(a).to(device, non_blocking=True)

    def stage(item):
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = _map_arrays(item, copy)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def hand_over(staged):
        out, done = staged
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _tensors(out):
            t.record_stream(current)
        return out

    return stage, hand_over


def prefetch_chunks(sources, load=None, depth: int = 2, device=None):
    """Iterate ``load(source)`` for each source, computed ahead on a worker
    thread.

    Parameters
    ----------
    sources : iterable
        Work items (file paths, chunk ids, closures...), consumed lazily.
    load : callable, optional
        Applied to each source on the worker thread (identity by default):
        file reads and parsing belong here.
    depth : int
        Most loaded but unconsumed chunks (bounded memory; ``depth=2``
        double-buffers).
    device : optional
        If given, each loaded chunk (an array or tensor, or a tuple or list
        of them) is staged onto ``device`` on the worker thread; onto a CUDA
        device by pinned, non-blocking copies on a stream of its own (see the
        module docstring), so that the copy overlaps the consumer's work.

    Yields
    ------
    The loaded chunks, in source order.  An exception raised by ``load``
    (or by the sources iterator) is raised to the consumer at the point of
    consumption.  Abandoning the iterator (``close`` or garbage collection)
    stops the worker promptly.
    """
    if depth < 1:
        msg = f"depth must be >= 1; got {depth}"
        raise ValueError(msg)
    stage, hand_over = _stager(device) if device is not None else (None, None)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded blocking put that notices the consumer's abandon
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
            except queue.Full:
                continue
            return True
        return False

    def _worker() -> None:
        try:
            for src in sources:
                if stop.is_set():
                    return
                item = load(src) if load is not None else src
                if stage is not None:
                    item = stage(item)
                if not _put(("item", item)):
                    return
        except BaseException as err:  # noqa: BLE001 - relayed to the consumer
            _put(("err", err))
        else:
            _put(_END)

    worker = threading.Thread(target=_worker, daemon=True, name="xtorch-prefetch")
    worker.start()
    try:
        while True:
            kind, val = q.get()
            if kind == "end":
                return
            if kind == "err":
                raise val
            yield val if hand_over is None else hand_over(val)
    finally:
        stop.set()


def _columns(table, columns):
    """``tuple(table[:, c] for c in columns)`` as contiguous arrays; a 1-D
    table is one column."""
    if table.ndim == 1:
        table = table[:, None]
    return tuple(np.ascontiguousarray(table[:, c]) for c in columns)


def read_table_chunks(paths, usecols=None, columns=None, depth: int = 2, device=None):
    """Prefetched iterator over whitespace / comma tables (one chunk per
    file), parsed by the C++ loader (:func:`.native.loadtxt_fast`).

    ``columns``: optional tuple of column selectors; each chunk is then
    ``tuple(table[:, c] for c in columns)``, ready to splat into a streaming
    ``update(state, uv, xv)`` through :func:`ingest_stream` (``columns=(0,
    1)`` for a ``u x`` table).
    """
    from . import native

    def _load(p):
        table = native.loadtxt_fast(p, usecols=usecols)
        return table if columns is None else _columns(table, columns)

    return prefetch_chunks(paths, load=_load, depth=depth, device=device)


def read_npy_chunks(paths, columns=None, depth: int = 2, device=None):
    """Prefetched iterator over ``.npy`` chunk files (one chunk per file),
    the binary counterpart of :func:`read_table_chunks` (a header parse and
    one contiguous read, so ingest runs at storage speed).

    ``columns`` as in :func:`read_table_chunks` (1-D files are one column).
    Object arrays are refused (``allow_pickle=False``).
    """

    def _load(p):
        arr = np.load(p, allow_pickle=False)
        return arr if columns is None else _columns(arr, columns)

    return prefetch_chunks(paths, load=_load, depth=depth, device=device)


def ingest_stream(update, state, chunks, depth: int = 2, load=None, device=None, fan_in: int = 1):
    """Fold a streaming-pipeline ``update`` over a prefetched chunk stream.

    ``update(state, *chunk) -> state`` (tuples and lists are splatted,
    anything else is passed as one argument).  Returns the final state.
    The update's kernels are queued on the card without a host wait, so each
    chunk's reduction overlaps the read and copy of the next.

    ``chunks`` may be raw sources (give ``load`` / ``device`` to prefetch
    them here) or an already prefetched iterator such as
    :func:`read_table_chunks`; with neither ``load`` nor ``device`` the
    stream is consumed as it is, not wrapped in a second prefetch layer.

    ``fan_in`` (>= 1) is accepted for the reference's signature: there it
    folds that many chunks per compiled program to spread a fixed dispatch
    cost.  Eager torch has no program to compile, so a group is folded chunk
    by chunk in order, and every ``fan_in`` gives the state of ``fan_in=1``.
    """
    if fan_in < 1:
        msg = f"fan_in must be >= 1; got {fan_in}"
        raise ValueError(msg)
    stream = chunks if load is None and device is None else prefetch_chunks(chunks, load=load, depth=depth, device=device)
    for chunk in stream:
        state = update(state, *chunk) if isinstance(chunk, (tuple, list)) else update(state, chunk)
    return state

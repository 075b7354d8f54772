"""The torch port's ingest runtime (``thermoextrap_tpu_torch.io_stream``), on
the CPU, with the port's streaming pipeline as the consumer.

Mirrors every case of ``tests/test_io_stream.py`` but the two group-program
cache cases (:187, :196): the reference compiles ``fan_in`` chunks into one
jitted program and caches it per ``update``; eager torch compiles nothing,
so ``fan_in`` groups are folded chunk by chunk and there is no cache to
test (``test_ingest_stream_fan_in_matches_sequential`` holds the states
equal, exactly).  File-fed states are also held to the JAX package's
ingest of the same files (rtol 1e-12, the JAX test's bar against the
one-shot pipeline).  The CUDA staging (a side stream, pinned copies, event
and ``record_stream`` hand-over) is checked in ``tests/test_torch_cuda.py``.
"""

import time

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy

from thermoextrap_tpu import io_stream as jio
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu_torch import io_stream, pipeline


def test_order_and_values_preserved():
    out = list(io_stream.prefetch_chunks(range(20), load=lambda i: i * i, depth=3))
    assert out == [i * i for i in range(20)]


def test_identity_load():
    assert list(io_stream.prefetch_chunks(["a", "b"], depth=1)) == ["a", "b"]


def test_exception_propagates_at_consumption():
    def load(i):
        if i == 3:
            msg = "boom"
            raise RuntimeError(msg)
        return i

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for v in io_stream.prefetch_chunks(range(10), load=load, depth=2):
            got.append(v)
    assert got == [0, 1, 2]


def test_depth_bounds_prefetch():
    loaded = []

    def load(i):
        loaded.append(i)
        return i

    it = io_stream.prefetch_chunks(range(100), load=load, depth=2)
    assert next(it) == 0
    deadline = time.monotonic() + 2.0
    while len(loaded) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    # one consumed + at most depth queued + one in flight
    assert len(loaded) <= 4
    it.close()


def test_abandoned_iterator_stops_worker():
    loaded = []
    it = io_stream.prefetch_chunks(range(10_000), load=lambda i: loaded.append(i) or i, depth=1)
    next(it)
    it.close()
    n_after_close = len(loaded)
    time.sleep(0.3)
    assert len(loaded) <= n_after_close + 2


def test_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        list(io_stream.prefetch_chunks([1], depth=0))


def test_device_staging_on_the_cpu():
    """``device=`` stages every array of a chunk (numpy or tensor, in tuples
    and lists) as a tensor on that device; other leaves pass unchanged."""
    chunks = [(np.arange(3.0), [torch.ones(2), 5]), np.zeros(2)]
    (a, (b, c)), d = list(io_stream.prefetch_chunks(chunks, device="cpu"))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in (a, b, d))
    assert c == 5 and npy(a).tolist() == [0.0, 1.0, 2.0]


def _write_tables(tmp_path, arrays, stem="chunk"):
    paths = []
    for i, a in enumerate(arrays):
        p = tmp_path / f"{stem}{i}.txt"
        np.savetxt(p, a)
        paths.append(p)
    return paths


def test_read_table_chunks_roundtrip(tmp_path, rng_np):
    arrays = [rng_np.normal(size=(50, 2)) for _ in range(4)]
    paths = _write_tables(tmp_path, arrays)
    got = list(io_stream.read_table_chunks(paths, depth=2))
    for g, e, j in zip(got, arrays, jio.read_table_chunks(paths, depth=2)):
        np.testing.assert_allclose(g, e, rtol=1e-10)
        np.testing.assert_array_equal(g, np.asarray(j))


def test_ingest_stream_matches_one_shot(tmp_path, rng_np):
    uv_full = rng_np.normal(3.0, 1.0, 4000)
    xv_full = rng_np.normal(1.0, 0.5, 4000)
    paths = _write_tables(
        tmp_path, [np.stack([uv_full[i * 1000 : (i + 1) * 1000], xv_full[i * 1000 : (i + 1) * 1000]], axis=1) for i in range(4)], "traj"
    )

    def load(p):
        t = np.loadtxt(p)
        return t[:, 0], t[:, 1]

    state0, update, predict = pipeline.make_streaming_extrap_pipeline(3, 1.0)
    state = io_stream.ingest_stream(update, state0, paths, load=load)
    betas = np.array([0.8, 1.0, 1.2])
    got = predict(state, betas)
    want = pipeline.make_extrap_pipeline(3, 1.0)(uv_full, xv_full[:, None], betas)[:, 0]
    assert_close(got, want, 1e-12)
    # the same files through the JAX package's ingest
    jstate0, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(3, 1.0, dtype=np.float64)
    assert_close(got, jpredict(jio.ingest_stream(jupdate, jstate0, paths, load=load), betas), 1e-12)


def test_read_table_chunks_columns_splat(tmp_path, rng_np):
    uv = rng_np.normal(size=300)
    xv = rng_np.normal(size=300)
    paths = _write_tables(tmp_path, [np.stack([uv[i * 100 : (i + 1) * 100], xv[i * 100 : (i + 1) * 100]], axis=1) for i in range(3)], "t")
    state0, update, predict = pipeline.make_streaming_extrap_pipeline(2, 1.0)
    state = io_stream.ingest_stream(update, state0, io_stream.read_table_chunks(paths, columns=(0, 1)))
    want = pipeline.make_extrap_pipeline(2, 1.0)(uv, xv[:, None], np.array([1.0]))[:, 0]
    assert_close(predict(state, np.array([1.0])), want, 1e-12)


def test_read_table_chunks_single_column_splat(tmp_path, rng_np):
    data = rng_np.normal(size=80)
    p = tmp_path / "one_col.txt"
    np.savetxt(p, data)
    (chunk,) = list(io_stream.read_table_chunks([p], columns=(0,)))
    np.testing.assert_allclose(chunk[0], data, rtol=1e-10)


def test_ingest_stream_consumes_prefetched_directly():
    consumed = []

    class Probe:
        def __iter__(self):
            return iter([(1.0,), (2.0,)])

    def update(state, v):
        consumed.append(v)
        return state + v

    out = io_stream.ingest_stream(update, 0.0, Probe())
    assert out == 3.0 and consumed == [1.0, 2.0]


def test_ingest_stream_fan_in_matches_sequential(rng_np):
    uv = rng_np.normal(3.0, 1.0, 700)
    xv = rng_np.normal(1.0, 0.5, 700)
    chunks = [(uv[i * 100 : (i + 1) * 100], xv[i * 100 : (i + 1) * 100]) for i in range(7)]
    state0, update, predict = pipeline.make_streaming_extrap_pipeline(3, 1.0, nrep=8, seed=5)
    seq = io_stream.ingest_stream(update, state0, iter(chunks))
    fan = io_stream.ingest_stream(update, state0, iter(chunks), fan_in=3)
    betas = np.array([0.8, 1.0, 1.2])
    for a, b in zip(predict(fan, betas), predict(seq, betas)):
        assert torch.equal(a, b)
    assert fan[2] == seq[2] == 7


def test_ingest_stream_fan_in_validation():
    with pytest.raises(ValueError, match="fan_in"):
        io_stream.ingest_stream(lambda s: s, 0.0, [], fan_in=0)


def test_read_npy_chunks_matches_one_shot(tmp_path):
    rng = np.random.default_rng(0)
    paths, chunks = [], []
    for i in range(3):
        arr = np.column_stack([rng.normal(3.0, 0.7, 500), rng.normal(1.5, 0.3, 500)])
        p = tmp_path / f"chunk{i}.npy"
        np.save(p, arr)
        paths.append(p)
        chunks.append(arr)
    full = np.concatenate(chunks)
    state, update, predict = pipeline.make_streaming_extrap_pipeline(2, 2.0)
    state = io_stream.ingest_stream(update, state, io_stream.read_npy_chunks(paths, columns=(0, 1)))
    got = predict(state, np.array([1.9, 2.1]))
    ref = pipeline.make_extrap_pipeline(2, 2.0)(full[:, 0], full[:, 1], np.array([1.9, 2.1]))
    assert_close(got, ref.reshape(got.shape), 1e-12)
    jstate, jupdate, jpredict = jpipe.make_streaming_extrap_pipeline(2, 2.0, dtype=np.float64)
    jstate = jio.ingest_stream(jupdate, jstate, jio.read_npy_chunks(paths, columns=(0, 1)))
    assert_close(got, jpredict(jstate, np.array([1.9, 2.1])), 1e-12)

    # 1-D files are one column; column selection still works
    p1 = tmp_path / "one.npy"
    np.save(p1, full[:, 0])
    (only,) = next(iter(io_stream.read_npy_chunks([p1], columns=(0,))))
    np.testing.assert_array_equal(only, full[:, 0])

    # pickled object files are refused
    pbad = tmp_path / "bad.npy"
    np.save(pbad, np.array([{"a": 1}], dtype=object), allow_pickle=True)
    with pytest.raises(ValueError):
        list(io_stream.read_npy_chunks([pbad]))

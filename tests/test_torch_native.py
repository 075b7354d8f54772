"""The torch port's compiled host engines (``thermoextrap_tpu_torch.native``)
against the JAX package's and against the port's plain float64 reduction, on
the CPU.

Mirrors ``tests/test_native.py``: the table loader against ``np.loadtxt``
(:25-91) and the moments engine (:123-227) at the JAX tests' inputs and bars,
with each result also held to the JAX package's engine on the same numpy
inputs, and the ``set_impl("native")`` routing (:229-271) on the port's
dispatch.  ``test_datawrapper_uses_fastloader`` waits for the active-learning
slice.  Also: the copied C++ sources are the JAX package's in code, the
engine refuses a tensor off the CPU, and the fallback route (no compiler)
gives the same numbers.
"""

import logging

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu import native as jnative
from thermoextrap_tpu_torch import native
from thermoextrap_tpu_torch.ops import dispatch, moments, resample


@pytest.fixture
def table_file(tmp_path, rng_np):
    data = np.concatenate([rng_np.normal(scale=1e3, size=(500, 3)), rng_np.normal(scale=1e-7, size=(500, 3))])
    path = tmp_path / "table.txt"
    with path.open("w") as f:
        f.write("# comment line\n")
        np.savetxt(f, data)
        f.write("# trailing comment\n")
    return path, data


@pytest.mark.parametrize("name", ["cmoments.cpp", "fastloader.cpp"])
def test_sources_are_the_jax_packages(name):
    """The port builds its own copies of the JAX package's C++ sources: every
    line of code is byte-equal to the original; only comment lines citing
    the reference's checkout may read differently."""
    from pathlib import Path

    import thermoextrap_tpu

    orig = (Path(thermoextrap_tpu.__file__).parent / "native" / name).read_bytes().splitlines()
    copy = (native.SOURCE_DIR / name).read_bytes().splitlines()
    assert len(copy) == len(orig)
    differ = [i for i, (a, b) in enumerate(zip(orig, copy)) if a != b]
    assert all(orig[i].lstrip().startswith(b"//") and copy[i].lstrip().startswith(b"//") for i in differ)
    assert len(differ) <= 2


def test_matches_numpy(table_file):
    path, data = table_file
    a = native.loadtxt_fast(path)
    np.testing.assert_allclose(a, np.loadtxt(path), rtol=5e-16)
    np.testing.assert_allclose(a, data, rtol=1e-10)
    np.testing.assert_array_equal(a, jnative.loadtxt_fast(path))


def test_single_column(tmp_path, rng_np):
    data = rng_np.normal(size=1000)
    path = tmp_path / "col.txt"
    np.savetxt(path, data)
    a = native.loadtxt_fast(path)
    assert a.ndim == 1
    np.testing.assert_allclose(a, data, rtol=5e-16)


def test_usecols_matches_numpy(table_file):
    path, _data = table_file
    for cols in (1, [2], [0, 2]):
        np.testing.assert_allclose(native.loadtxt_fast(path, usecols=cols), np.loadtxt(path, usecols=cols), rtol=5e-16)


def test_usecols_out_of_range_raises(tmp_path, rng_np):
    path = tmp_path / "col.txt"
    np.savetxt(path, rng_np.normal(size=50))
    with pytest.raises(Exception):  # noqa: B017 - np.loadtxt raises ValueError, the fast path IndexError
        native.loadtxt_fast(path, usecols=2)


def test_int_and_exponent_formats(tmp_path):
    path = tmp_path / "mixed.txt"
    path.write_text("1 2.5 -3e2\n4.0E-3 +5 6.25d1\n")
    np.testing.assert_allclose(native.loadtxt_fast(path), [[1.0, 2.5, -300.0], [0.004, 5.0, 62.5]], rtol=1e-15)


# -- the moments engine ----------------------------------------------------------------------


@pytest.fixture
def flat_samples(rng_np):
    r = 777
    return rng_np.normal(3.0, 1.0, r), rng_np.normal(0.5, 2.0, (r, 3)), rng_np.uniform(0.2, 1.5, r)


def _plain(fn, *arrays, **kws):
    """The port's plain float64 reduction on numpy inputs, as numpy."""
    return tuple(npy(o) for o in fn(*(None if a is None else tt(a) for a in arrays), **kws))


def test_engine_available():
    assert native.available()


def test_reduce_central_matches_plain(flat_samples):
    uv, xv, w = flat_samples
    got = native.reduce_central_comoments(uv, xv, 6, weight=w)
    assert all(isinstance(g, np.ndarray) for g in got)
    assert_close(got, _plain(moments.reduce_central_comoments, uv, xv, 6, weight=tt(w)), 1e-12, 1e-14)
    assert_close(got, jnative.reduce_central_comoments(uv, xv, 6, weight=w), 1e-12, 1e-14)
    assert got[2][0] == 1.0 and got[2][1] == 0.0
    np.testing.assert_array_equal(got[3][0], 0.0)


def test_reduce_central_unweighted_scalar_val(flat_samples):
    uv, xv, _ = flat_samples
    got = native.reduce_central_comoments(uv, xv[:, :1], 4)
    assert_close(got, _plain(moments.reduce_central_comoments, uv, xv[:, :1], 4), 1e-12, 1e-14)


def test_reduce_central_batched_matches_plain(rng_np):
    uv = rng_np.normal(1.0, 0.5, (2, 3, 250))
    xv = rng_np.normal(0.0, 1.0, (2, 3, 250, 2))
    w = rng_np.uniform(0.5, 1.0, (2, 3, 250))
    got = native.reduce_central_comoments(uv, xv, 5, weight=w)
    assert_close(got, _plain(moments.reduce_central_comoments, uv, xv, 5, weight=tt(w)), 1e-12, 1e-14)
    assert_close(got, jnative.reduce_central_comoments(uv, xv, 5, weight=w), 1e-12, 1e-14)


def test_reduce_raw_matches_plain(flat_samples):
    uv, xv, w = flat_samples
    got = native.reduce_raw_comoments(uv, xv, 6, weight=w)
    assert_close(got, _plain(moments.reduce_raw_comoments, uv, xv, 6, weight=tt(w)), 1e-11)
    assert_close(got, jnative.reduce_raw_comoments(uv, xv, 6, weight=w), 1e-12)


def test_resample_matches_plain(flat_samples, rng_np):
    uv, xv, w = flat_samples
    nrep, r = 16, uv.shape[0]
    idx = rng_np.integers(0, r, (nrep, r))
    freq = np.zeros((nrep, r), dtype=np.int64)
    np.add.at(freq, (np.repeat(np.arange(nrep), r), idx.ravel()), 1)
    got = native.resample_central_comoments(uv, xv, freq, 4, weight=w)
    assert_close(got, _plain(resample.resample_central_comoments, uv, xv, freq, 4, weight=tt(w)), 1e-9, 1e-12)
    assert_close(got, jnative.resample_central_comoments(uv, xv, freq, 4, weight=w), 1e-12, 1e-14)


def test_resample_zero_replicate_degenerate_standin(flat_samples):
    uv, xv, w = flat_samples
    freq = np.ones((3, uv.shape[0]))
    freq[1] = 0.0
    got = native.resample_central_comoments(uv, xv, freq, 3, weight=w)
    assert all(np.isfinite(g).all() for g in got)
    assert_close(got, _plain(resample.resample_central_comoments, uv, xv, freq, 3, weight=tt(w)), 1e-9, 1e-12)


def _same_nans(got, want, rtol=1e-12, atol=0.0):
    for g, e in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(e))
        np.testing.assert_allclose(g[~np.isnan(g)], e[~np.isnan(e)], rtol=rtol, atol=atol)


def test_zero_total_weight_matches_plain_nan_convention(flat_samples):
    uv, xv, _ = flat_samples
    w0 = np.zeros_like(uv)
    got = native.reduce_central_comoments(uv, xv, 3, weight=w0)
    _same_nans(got, _plain(moments.reduce_central_comoments, uv, xv, 3, weight=tt(w0)))
    u, xu = native.reduce_raw_comoments(uv, xv, 3, weight=w0)
    assert np.isnan(u).all() and np.isnan(xu).all()


def test_resample_zero_total_weight_matches_plain_nan_convention(flat_samples):
    uv, xv, _ = flat_samples
    w0 = np.zeros_like(uv)
    freq = np.ones((3, uv.shape[0]))
    got = native.resample_central_comoments(uv, xv, freq, 4, weight=w0)
    _same_nans(got, jnative.resample_central_comoments(uv, xv, freq, 4, weight=w0))


def test_zero_weight_batch_row_nans_that_row_only(rng_np):
    uv = rng_np.normal(1.0, 0.5, (3, 200))
    xv = rng_np.normal(0.0, 1.0, (3, 200, 1))
    w = np.ones((3, 200))
    w[1] = 0.0
    got = native.reduce_central_comoments(uv, xv, 3, weight=w)
    _same_nans(got, _plain(moments.reduce_central_comoments, uv, xv, 3, weight=tt(w)), atol=1e-14)
    assert np.isnan(got[0][1]).all() and np.isfinite(got[0][[0, 2]]).all()


def test_cpu_tensors_in_numpy_out(flat_samples):
    """CPU tensors (float32 too) are read as float64 host arrays."""
    uv, xv, w = flat_samples
    got = native.reduce_central_comoments(tt(uv), tt(xv), 4, weight=tt(w))
    assert all(isinstance(g, np.ndarray) for g in got)
    assert_close(got, native.reduce_central_comoments(uv, xv, 4, weight=w), 0.0)
    got32 = native.reduce_central_comoments(tt(uv, torch.float32), tt(xv, torch.float32), 4)
    assert_close(got32, native.reduce_central_comoments(uv.astype(np.float32), xv.astype(np.float32), 4), 0.0)


def test_device_tensor_raises(flat_samples):
    """A tensor off the CPU (the meta device standing in for the card) is
    refused with its device named, never copied to the host."""
    uv, xv, w = flat_samples
    meta = torch.empty(uv.shape, device="meta")
    with pytest.raises(ValueError, match="meta"):
        native.reduce_central_comoments(meta, xv, 3)
    with pytest.raises(ValueError, match="meta"):
        native.reduce_central_comoments(uv, xv, 3, weight=meta)
    with pytest.raises(ValueError, match="meta"):
        native.reduce_raw_comoments(meta, xv, 3)
    with pytest.raises(ValueError, match="meta"):
        native.resample_central_comoments(uv, xv, torch.ones((2, uv.shape[0]), device="meta"), 3)


def test_fallback_without_a_library(flat_samples, tmp_path, monkeypatch, caplog):
    """Where the library cannot be built the engine logs a warning and runs
    the port's plain float64 reduction on the CPU: same numbers, numpy out."""
    uv, xv, w = flat_samples
    want = (
        native.reduce_central_comoments(uv, xv, 4, weight=w),
        native.reduce_raw_comoments(uv, xv, 4, weight=w),
        native.resample_central_comoments(uv, xv, np.ones((2, uv.shape[0])), 4, weight=w),
    )
    monkeypatch.setattr(native, "_LIBS", {})
    blocked = tmp_path / "not_a_dir"
    blocked.write_text("")
    monkeypatch.setattr(native, "BUILD_DIR", blocked)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        got = (
            native.reduce_central_comoments(uv, xv, 4, weight=w),
            native.reduce_raw_comoments(uv, xv, 4, weight=w),
            native.resample_central_comoments(uv, xv, np.ones((2, uv.shape[0])), 4, weight=w),
        )
    assert "fallback" in caplog.text
    for g, e in zip(got, want):
        assert all(isinstance(a, np.ndarray) for a in g)
        assert_close(g, e, 1e-10, 1e-14)


def test_untrusted_build_dir_is_refused(tmp_path, monkeypatch):
    """A build directory others may write to is not used: nothing is loaded
    from it."""
    d = tmp_path / "host"
    d.mkdir(mode=0o777)
    d.chmod(0o777)
    monkeypatch.setattr(native, "BUILD_DIR", d)
    assert native._cache_dir() is None
    d.chmod(0o700)
    assert native._cache_dir() == d


# -- set_impl("native") on the port's dispatch ---------------------------------------------------


def test_dispatch_native_routing(flat_samples):
    uv, xv, w = flat_samples
    with dispatch.use_impl("native"):
        got = dispatch.reduce_central(tt(uv), tt(xv), 4, weight=tt(w))
        got_np = dispatch.reduce_central(uv, xv, 4, weight=w)
        uave, du = dispatch.reduce_central_u(tt(uv)[None], 4)
    # served by the C++ engine: its numbers, handed back as float64 CPU tensors
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" and g.dtype == torch.float64 for g in got)
    assert_close(got, native.reduce_central_comoments(uv, xv, 4, weight=w), 0.0)
    assert_close(got_np, got, 0.0)
    assert_close(got, _plain(moments.reduce_central_comoments, uv, xv, 4, weight=tt(w)), 1e-12, 1e-14)
    assert_close((uave, du), _plain(moments.reduce_central_umoments, uv[None], 4), 1e-12, 1e-14)
    with pytest.raises(ValueError, match="impl must be"):
        dispatch.set_impl("pallas")


def test_dispatch_native_keeps_device_tensors_off_the_engine(flat_samples, monkeypatch):
    """A tensor off the CPU keeps its device route under ``"native"``: the
    engine is never asked (the meta device stands in for the card)."""
    uv, xv, _ = flat_samples
    calls = []
    monkeypatch.setattr(native, "reduce_central_comoments", lambda *a, **k: calls.append(a))
    with dispatch.use_impl("native"):
        assert not dispatch._use_native(torch.empty(3, device="meta"), None)
        assert dispatch._use_native(tt(uv), None, uv)
        out = dispatch.reduce_central(torch.empty(uv.shape, device="meta"), torch.empty(xv.shape, device="meta"), 3)
    assert out[0].device.type == "meta" and not calls


def test_dispatch_native_resample_and_raw(flat_samples, rng_np):
    uv, xv, w = flat_samples
    freq = rng_np.poisson(1.0, (8, uv.shape[0])).astype(np.float64)
    with dispatch.use_impl("native"):
        got = dispatch.resample_central(tt(uv), tt(xv), tt(freq), 3, weight=tt(w))
        got_raw = dispatch.reduce_raw(tt(uv), tt(xv), 3, weight=tt(w))
    assert_close(got, _plain(resample.resample_central_comoments, uv, xv, freq, 3, weight=tt(w)), 1e-9, 1e-12)
    assert_close(got_raw, _plain(moments.reduce_raw_comoments, uv, xv, 3, weight=tt(w)), 1e-11)
    assert_close(got, native.resample_central_comoments(uv, xv, freq, 3, weight=w), 0.0)


def test_native_data_layer_end_to_end(flat_samples):
    """A model built while the native backend is forced has the derivatives
    of the plain path (and of the JAX package's native route)."""
    from thermoextrap_tpu import factory_data_values as jfactory
    from thermoextrap_tpu.beta import factory_extrapmodel as jfactory_model
    from thermoextrap_tpu.ops import dispatch as jdispatch
    from thermoextrap_tpu_torch import factory_data_values
    from thermoextrap_tpu_torch.beta import factory_extrapmodel

    uv, xv, _ = flat_samples

    def build():
        return npy(factory_extrapmodel(1.0, factory_data_values(uv=uv, xv=xv[:, 0], order=3, central=True)).derivs())

    with dispatch.use_impl("native"):
        d_native = build()
    np.testing.assert_allclose(d_native, build(), rtol=1e-10)
    jdispatch.set_impl("native")
    try:
        d_jax = np.asarray(jfactory_model(1.0, jfactory(uv=uv, xv=xv[:, 0], order=3, central=True)).derivs())
    finally:
        jdispatch.set_impl(None)
    np.testing.assert_allclose(d_native, d_jax, rtol=1e-10)

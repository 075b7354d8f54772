"""tests/test_edges.py :17-:89 on the torch port: degenerate orders, tiny
data, one replicate, a scalar observable, zero weights and the raise on an
``n``-indexed order overflow; where the JAX test holds a number, the port
is also held to the JAX package's on the same inputs (1e-10).  The
collection-order case is in tests/test_torch_models.py.  The counterpart of
:116, the compilation cache, points the port's library builds at a
directory."""

import numpy as np
import pytest
from _torch_parity import npy

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jb
from thermoextrap_tpu_torch import beta as beta_xpan

RTOL = 1e-10


@pytest.fixture
def small(rng_np):
    u = rng_np.normal(2.0, 1.0, 32)
    x = rng_np.normal(1.0, 0.5, (32, 1))
    return u, x


def _model(pkg, beta, **kws):
    data = pkg.factory_data_values(**kws)
    return (jb if pkg is jx else beta_xpan).factory_extrapmodel(beta, data)


def test_order_zero_extrapolation(small):
    """Order 0: prediction is the sample mean everywhere."""
    u, x = small
    model = _model(tx, 1.0, uv=u, xv=x, order=0, central=True)
    p1, p2 = npy(model.predict(1.0)), npy(model.predict(5.0))
    np.testing.assert_allclose(p1, p2, rtol=1e-12)
    np.testing.assert_allclose(p1[0], x.mean(), rtol=1e-12)


def test_order_one(small):
    """Order 1: the classic -cov(x, u) first derivative."""
    u, x = small
    derivs = npy(_model(tx, 1.0, uv=u, xv=x, order=1, central=True).derivs())
    cov = ((x[:, 0] - x.mean()) * (u - u.mean())).mean()
    np.testing.assert_allclose(derivs[1, 0], -cov, rtol=1e-10)
    ref = np.asarray(_model(jx, 1.0, uv=u, xv=x, order=1, central=True).derivs())
    np.testing.assert_allclose(derivs, ref, rtol=RTOL)


def test_single_bootstrap_replicate(small):
    u, x = small
    boot = tx.DataCentralMomentsVals.from_vals(x, u, 2).resample({"nrep": 1})
    assert npy(beta_xpan.factory_extrapmodel(1.0, boot).predict(1.1)).shape == (1, 1)


def test_tiny_dataset():
    """Fewer samples than moment order still computes."""
    u = np.array([1.0, 2.0, 3.0])
    x = np.array([[0.5], [1.5], [2.5]])
    got = npy(_model(tx, 0.5, uv=u, xv=x, order=2, central=True).predict(0.6))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(_model(jx, 0.5, uv=u, xv=x, order=2, central=True).predict(0.6)), rtol=RTOL)


def test_scalar_observable_no_val_axis(small):
    """xv with no val axis at all (pure scalar observable)."""
    u, x = small
    out = npy(_model(tx, 1.0, uv=u, xv=x[:, 0], order=3, central=True).predict(np.array([0.9, 1.1])))
    assert out.shape == (2,)
    ref = np.asarray(_model(jx, 1.0, uv=u, xv=x[:, 0], order=3, central=True).predict(np.array([0.9, 1.1])))
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_weight_zero_samples_excluded(small):
    """Zero-weighted samples must not contribute."""
    u, x = small
    w = np.ones_like(u)
    w[10:] = 0.0
    d_w = tx.factory_data_values(uv=u, xv=x, order=3, central=True, weight=w)
    d_t = tx.factory_data_values(uv=u[:10], xv=x[:10], order=3, central=True)
    for a, b in zip(d_w.derivs_args, d_t.derivs_args):
        np.testing.assert_allclose(npy(a), npy(b), rtol=1e-10, atol=1e-12)


def test_n_indexed_order_overflow_raises(rng_np):
    """n-indexed observables need moments up to n + order: the factory
    rejects the overflow instead of reading past the last moment entry."""
    u = rng_np.normal(2.0, 1.0, 64)
    d_raw = tx.DataValues.from_vals(None, u, order=4, central=False, x_is_u=True)
    with pytest.raises(ValueError, match="moment entries"):
        beta_xpan.factory_extrapmodel(1.0, d_raw, name="un_ave", n=3)
    m = beta_xpan.factory_extrapmodel(1.0, d_raw, name="un_ave", n=3, order=2)
    assert np.isfinite(npy(m.derivs())).all()

    d_cen = tx.DataValues.from_vals(None, u, order=4, central=True, x_is_u=True)
    with pytest.raises(ValueError, match="moment entries"):
        beta_xpan.factory_extrapmodel(1.0, d_cen, name="dun_ave", n=2)

    x = rng_np.normal(1.0, 0.5, (64, 1))
    d_x = tx.factory_data_values(uv=u, xv=x, order=4, central=False)
    with pytest.raises(ValueError, match="moment entries"):
        beta_xpan.factory_extrapmodel(1.0, d_x, name="xun_ave", n=1)
    m2 = beta_xpan.factory_extrapmodel(1.0, d_x, name="xun_ave", n=1, order=3)
    assert np.isfinite(npy(m2.derivs())).all()


def test_compilation_cache_builds_there(tmp_path, monkeypatch):
    """tests/test_edges.py:116 on the port: after ``enable_compilation_cache``
    the kernel library (and its CPU emulation) builds under the directory and
    the host engine, built by g++ here, writes its library into it (the
    emulation's g++ build takes ~16 s, the engine's ~3 s)."""
    import shutil

    from thermoextrap_tpu_torch import native
    from thermoextrap_tpu_torch.ops import _build
    from thermoextrap_tpu_torch.utils import enable_compilation_cache

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_LIBS", {})
    cache = enable_compilation_cache(tmp_path / "kernels")
    assert cache.is_dir() and _build.BUILD_DIR == cache
    u = np.linspace(0.0, 1.0, 100)
    tx.native.reduce_central_comoments(u, u[:, None], 2)
    assert [p.parent for p in cache.rglob("*.so")] == [cache / "host"], "no library written"

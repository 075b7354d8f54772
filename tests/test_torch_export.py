"""The torch port's batch serving artifacts (``serving_export``: extrap,
lnΠ, volume, perturbation, MBAR and the frozen GPR predictor) against the
JAX package's artifacts and the port's in-process routes, on the CPU.

Mirrors tests/test_export.py :36-:212, :394-:430, :454-:463, :494-:586 and
:637-:745, and tests/test_gpr_serving.py:269-292.  Inputs are made with
numpy from a seed and go through both packages.  Bars, with their reasons:

- deterministic outputs of a float64 artifact against the JAX package's
  float64 artifact: rtol 1e-10 (the same two-pass sums in another order);
- float32 artifacts: the JAX suite's 2e-6 (the port sums in float64 and
  rounds the outputs to float32, the JAX artifact sums in float32); the lnΠ
  grid keeps the JAX test's 3e-5;
- the bootstrap σ of a float64 artifact against the port's plain bootstrap
  on the same traced counts (``resample_poisson_plain(seed=)`` and its
  perturbation and u-moment forms): rtol 1e-12;
- the bootstrap σ against the JAX artifact's, whose counts are other
  draws: a ratio within [0.7, 1.4] at 256 replicates (~4% relative error
  of each side at that count);
- MBAR: the JAX test's bars (|Δf| 1e-11, the grid rtol 1e-9, float64);
- GPR: the JAX test's bars (float64 mean 1e-9, variance 1e-7 against
  ``predict_f``; float32 equal to the bit to ``freeze_predictor``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import npy, tt

from thermoextrap_tpu import serving_export as jse
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch import serving_export as se
from thermoextrap_tpu_torch.models import mbar as tmbar
from thermoextrap_tpu_torch.ops import moments_cuda as mc

ROOT = Path(__file__).resolve().parent.parent
BETAS = np.array([0.8, 1.0, 1.3])


def _data(r=257, v=2, seed=0):
    rng = np.random.default_rng(seed)
    uv = 5.0 + rng.normal(size=r)
    xv = 2.0 + 0.4 * rng.normal(size=(r, v))
    return uv, xv


def _freeze(kw):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in kw.items()))


@functools.lru_cache(maxsize=None)
def _port(family, kw):
    return getattr(se, f"export_{family}")(**dict(kw))


@functools.lru_cache(maxsize=None)
def _jax(family, kw):
    return getattr(jse, f"export_{family}")(**dict(kw))


def port(family, **kw):
    """One port artifact per configuration in this module."""
    return _port(family, _freeze(kw))


def jaxa(family, **kw):
    """One JAX artifact per configuration in this module."""
    kw = {k: ({torch.float64: jnp.float64, torch.float32: jnp.float32}[v] if k == "dtype" else v) for k, v in kw.items()}
    return _jax(family, _freeze(kw))


F64 = {"dtype": torch.float64}


def test_extrap_export_matches_jax_and_is_polymorphic():
    """test_export.py:36: one artifact, two sample counts (and one of a
    single sample), against the JAX artifact and the port's pipeline."""
    art = port("extrap_pipeline", order=4, beta0=1.0, **F64)
    assert set(art.platforms) == {"cpu", "cuda"}
    jart = jaxa("extrap_pipeline", order=4, beta0=1.0, **F64)
    run = tpipe.make_extrap_pipeline(4, 1.0)
    for r in (257, 64):
        uv, xv = _data(r)
        got = npy(art(uv, xv, BETAS))
        assert got.shape == (3, 2) and got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(jart(uv, xv, BETAS)), rtol=1e-10)
        np.testing.assert_allclose(got, npy(run(uv, xv, BETAS)), rtol=1e-10)
    # float32 artifacts at the JAX suite's bar
    art32 = port("extrap_pipeline", order=4, beta0=1.0)
    jart32 = jaxa("extrap_pipeline", order=4, beta0=1.0)
    uv, xv = (a.astype(np.float32) for a in _data(257))
    b32 = BETAS.astype(np.float32)
    np.testing.assert_allclose(npy(art32(uv, xv, b32)), np.asarray(jart32(uv, xv, b32)), rtol=2e-6, atol=2e-6)
    # size-1 dims are the same program (Dim(min=1)): one sample, one target
    one = npy(art(uv[:1].astype(np.float64), xv[:1, :1].astype(np.float64), [1.0]))
    assert one.shape == (1, 1)
    np.testing.assert_allclose(one, xv[:1, :1], rtol=1e-12)


def test_extrap_export_roundtrip_file(tmp_path):
    """test_export.py:48: save, load, the same numbers."""
    art = port("extrap_pipeline", order=3, beta0=1.0, minus_log=True)
    path = tmp_path / "extrap.thexport"
    art.save(path)
    art2 = se.load_exported(path)
    assert art2.meta == art.meta
    assert art2.platforms == art.platforms
    uv, xv = (a.astype(np.float32) for a in _data(128, 1))
    np.testing.assert_array_equal(npy(art(uv, xv, BETAS)), npy(art2(uv, xv, BETAS)))
    jart = jaxa("extrap_pipeline", order=3, beta0=1.0, minus_log=True)
    np.testing.assert_allclose(npy(art2(uv, xv, BETAS)), np.asarray(jart(uv, xv, BETAS.astype(np.float32))), rtol=2e-6, atol=2e-6)


def test_extrap_export_weighted():
    """test_export.py:60."""
    art = port("extrap_pipeline", order=3, beta0=1.0, weighted=True, **F64)
    jart = jaxa("extrap_pipeline", order=3, beta0=1.0, weighted=True, **F64)
    uv, xv = _data(200)
    w = np.random.default_rng(3).uniform(0.5, 2.0, 200)
    got = npy(art(uv, xv, BETAS, weight=w))
    np.testing.assert_allclose(got, np.asarray(jart(uv, xv, BETAS, weight=w)), rtol=1e-10)
    np.testing.assert_allclose(got, npy(tpipe.make_extrap_pipeline(3, 1.0, weighted=True)(uv, xv, BETAS, w)), rtol=1e-10)
    with pytest.raises(ValueError, match="weighted"):
        art(uv, xv, BETAS)


def test_extrap_export_bootstrap_ci():
    """test_export.py:72: the replicates are the plain bootstrap on K3's
    counts at the call's seed; deterministic in the seed; statistically
    the JAX artifact's."""
    nrep = 256
    art = port("extrap_pipeline", order=2, beta0=1.0, nrep=nrep, **F64)
    uv, xv = _data(4096)
    pred, std = (npy(a) for a in art(uv, xv, BETAS, seed=7))
    assert pred.shape == std.shape == (3, 2)
    assert np.all(std > 0) and np.all(np.isfinite(std))
    sem = xv.std(axis=0) / np.sqrt(len(uv))
    assert np.all(std[1] < 5 * sem) and np.all(std[1] > sem / 5)
    # the plain version of K3 on the same counts
    from thermoextrap_tpu_torch.models.derivatives import central_x_ave_coefs
    from thermoextrap_tpu_torch.models.extrap import _poly_eval

    bx, _bu, bdu, bdxdu, _w = mc.resample_poisson_plain(tt(uv), tt(xv), nrep, 2, seed=7)
    bpred = _poly_eval(central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, 2), tt(BETAS) - 1.0)
    np.testing.assert_allclose(std, npy(bpred.std(dim=1, correction=0)), rtol=1e-12)
    np.testing.assert_array_equal(std, npy(art(uv, xv, BETAS, seed=7)[1]))
    assert np.any(npy(art(uv, xv, BETAS, seed=8)[1]) != std)
    # a seed past 2^63 is the kernels' seed mod 2^64
    big = 2**64 - 3
    bx, _bu, bdu, bdxdu, _w = mc.resample_poisson_plain(tt(uv), tt(xv), nrep, 2, seed=big)
    bpred = _poly_eval(central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, 2), tt(BETAS) - 1.0)
    np.testing.assert_allclose(npy(art(uv, xv, BETAS, seed=big)[1]), npy(bpred.std(dim=1, correction=0)), rtol=1e-12)
    jpred, jstd = (np.asarray(a) for a in jaxa("extrap_pipeline", order=2, beta0=1.0, nrep=nrep, **F64)(uv, xv, BETAS, seed=7))
    np.testing.assert_allclose(pred, jpred, rtol=1e-10)
    ratio = std / jstd
    assert np.all((ratio > 0.7) & (ratio < 1.4)), ratio


def test_extrap_export_pinned_nval():
    """test_export.py:90."""
    art = port("extrap_pipeline", order=2, beta0=1.0, nval=3, **F64)
    uv, _ = _data(100)
    xv = np.random.default_rng(5).normal(2, 0.3, (100, 3))
    out = npy(art(uv, xv, BETAS))
    assert out.shape == (3, 3)
    np.testing.assert_allclose(out, np.asarray(jaxa("extrap_pipeline", order=2, beta0=1.0, nval=3, **F64)(uv, xv, BETAS)), rtol=1e-10)
    with pytest.raises(ValueError, match="nval=3"):
        art(uv, xv[:, :2], BETAS)


def test_lnpi_export_matches_jax(tmp_path):
    """test_export.py:100: the grid, and its bootstrap through a file (K5's
    counts, shared by the grid)."""
    order, beta0 = 3, 0.8
    rng = np.random.default_rng(11)
    grid = (4, 3)
    uv = 10.0 + rng.normal(size=(*grid, 500))
    lnpi0 = rng.normal(size=grid)
    mudotn = rng.normal(size=grid)
    art = port("lnpi_pipeline", order=order, beta0=beta0, **F64)
    got = npy(art(uv, lnpi0, mudotn, BETAS))
    assert got.shape == (3, *grid)
    np.testing.assert_allclose(got, np.asarray(jaxa("lnpi_pipeline", order=order, beta0=beta0, **F64)(uv, lnpi0, mudotn, BETAS)), rtol=1e-10)
    np.testing.assert_allclose(got, npy(tpipe.make_lnpi_pipeline(order, beta0)(uv, lnpi0, mudotn, BETAS)), rtol=1e-10)
    art32 = port("lnpi_pipeline", order=order, beta0=beta0)
    f32 = [a.astype(np.float32) for a in (uv, lnpi0, mudotn, BETAS)]
    np.testing.assert_allclose(npy(art32(*f32)), np.asarray(jaxa("lnpi_pipeline", order=order, beta0=beta0)(*f32)), rtol=3e-5, atol=3e-5)
    art_ci = port("lnpi_pipeline", order=order, beta0=beta0, nrep=32, **F64)
    path = tmp_path / "lnpi.thexport"
    art_ci.save(path)
    art_ci = se.load_exported(path)
    pred, std = (npy(a) for a in art_ci(uv, lnpi0, mudotn, BETAS, seed=3))
    assert pred.shape == std.shape == (3, *grid)
    assert np.all(np.isfinite(std))
    np.testing.assert_allclose(pred, got, rtol=1e-12)
    # K5's plain version on the same counts
    from thermoextrap_tpu_torch.models.derivatives import central_u_ave_coefs, lnpi_coefs
    from thermoextrap_tpu_torch.models.extrap import _poly_eval

    bu, bdu = mc.resample_umoments_poisson_plain(tt(uv).reshape(-1, 500), None, 32, order, seed=3)[:2]
    coefs = lnpi_coefs(central_u_ave_coefs(bu, bdu, order - 1), tt(lnpi0).reshape(1, -1), tt(mudotn).reshape(1, -1), order)
    want = _poly_eval(coefs, tt(BETAS) - beta0).std(dim=1, correction=0).reshape(3, *grid)
    np.testing.assert_allclose(std, npy(want), rtol=1e-12)


def test_lnpi_export_rejects_order_zero():
    """test_export.py:124."""
    with pytest.raises(ValueError, match="order"):
        se.export_lnpi_pipeline(order=0, beta0=1.0)


def test_load_rejects_foreign_and_jax_files(tmp_path):
    """test_export.py:129, and a JAX artifact named as such."""
    path = tmp_path / "junk.bin"
    path.write_bytes(b"not an artifact\nat all\nreally")
    with pytest.raises(ValueError, match="artifact"):
        se.load_exported(path)
    path.write_bytes(b"\x00raw binary, no newlines")
    with pytest.raises(ValueError, match="artifact"):
        se.load_exported(path)
    jpath = tmp_path / "jax.thexport"
    jaxa("extrap_pipeline", order=2, beta0=1.0).save(jpath)
    with pytest.raises(ValueError, match="JAX artifact"):
        se.load_exported(jpath)


def test_unweighted_artifact_rejects_weight():
    """test_export.py:140."""
    art = port("extrap_pipeline", order=2, beta0=1.0)
    uv, xv = _data(16)
    with pytest.raises(ValueError, match="no weight operand"):
        art(uv, xv, BETAS, weight=np.ones(16))


def test_cross_process_reload(tmp_path):
    """test_export.py:147: a fresh interpreter serves the file with
    ``torch.export.export`` patched to raise, so it traces nothing, and
    never imports jax."""
    art = port("extrap_pipeline", order=4, beta0=1.0)
    path = tmp_path / "extrap.thexport"
    art.save(path)
    uv, xv = (a.astype(np.float32) for a in _data(300))
    np.save(tmp_path / "uv.npy", uv)
    np.save(tmp_path / "xv.npy", xv)
    want = npy(art(uv, xv, BETAS))
    child = f"""
import sys
import numpy as np
import torch, torch.export
def _refuse(*a, **k):
    raise RuntimeError("traced in the serving process")
torch.export.export = _refuse
from thermoextrap_tpu_torch import set_default_device
from thermoextrap_tpu_torch.serving_export import load_exported
set_default_device("cpu")
art = load_exported({str(path)!r})
uv = np.load({str(tmp_path / 'uv.npy')!r})
xv = np.load({str(tmp_path / 'xv.npy')!r})
out = art(uv, xv, np.array([0.8, 1.0, 1.3])).numpy()
np.save({str(tmp_path / 'out.npy')!r}, out)
print("META", art.meta["family"], art.meta["order"], "jax" in sys.modules)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=300, check=False, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "META extrap 4 False" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def test_bucketed_runner_pads_exactly():
    """test_export.py:183."""
    art = port("extrap_pipeline", order=3, beta0=1.0, weighted=True)
    serve = se.bucketed_runner(art, buckets=(64, 256))
    uv, xv = (a.astype(np.float32) for a in _data(50))
    got = npy(serve(uv, xv, BETAS))
    want = npy(art(uv, xv, BETAS, weight=np.ones(50, np.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    uv2, xv2 = _data(300)
    assert npy(serve(uv2, xv2, BETAS)).shape == (3, 2)
    with pytest.raises(ValueError, match="at least one sample"):
        serve(uv[:0], xv[:0], BETAS)


def test_bucketed_runner_rejects_unweighted():
    """test_export.py:198."""
    with pytest.raises(ValueError, match="weighted=True"):
        se.bucketed_runner(port("extrap_pipeline", order=2, beta0=1.0))


def test_exported_dtype_coercion():
    """test_export.py:204: float64 inputs are cast to the exported float32."""
    art = port("extrap_pipeline", order=2, beta0=1.0)
    uv, xv = _data(64)
    out = art(uv, xv, [1.0])
    assert out.shape == (1, 2) and out.dtype == torch.float32


def _xalpha_data(r=257, order=3, seed=0):
    rng = np.random.default_rng(seed)
    uv = 5.0 + rng.normal(size=r)
    base = 2.0 + 0.4 * rng.normal(size=(r, 1))
    xv = np.zeros((r, order + 1, 1))
    xv[:, 0] = 2.0 * base
    xv[:, 1] = base
    return uv, xv


def test_extrap_export_xalpha_matches_jax():
    """test_export.py:394."""
    art = port("extrap_pipeline", order=3, beta0=1.0, xalpha=True, **F64)
    jart = jaxa("extrap_pipeline", order=3, beta0=1.0, xalpha=True, **F64)
    run = tpipe.make_extrap_pipeline(3, 1.0, xalpha=True)
    for r in (257, 64):
        uv, xv = _xalpha_data(r)
        got = npy(art(uv, xv, BETAS))
        assert got.shape == (3, 1)
        np.testing.assert_allclose(got, np.asarray(jart(uv, xv, BETAS)), rtol=1e-10)
        np.testing.assert_allclose(got, npy(run(uv, xv, BETAS)).reshape(got.shape), rtol=1e-10)


def test_extrap_export_xalpha_shape_guard():
    """test_export.py:407."""
    art = port("extrap_pipeline", order=3, beta0=1.0, xalpha=True, **F64)
    uv, xv = _xalpha_data()
    with pytest.raises(ValueError, match="deriv axis"):
        art(uv, xv[:, :3], BETAS)


def test_extrap_export_xalpha_bootstrap_roundtrip(tmp_path):
    """test_export.py:414."""
    art = port("extrap_pipeline", order=3, beta0=1.0, xalpha=True, nrep=32)
    path = tmp_path / "xalpha.thexport"
    art.save(path)
    art2 = se.load_exported(path)
    uv, xv = _xalpha_data()
    pred, std = (npy(a) for a in art2(uv, xv, BETAS, seed=5))
    assert pred.shape == std.shape == (3, 1)
    assert np.all(np.isfinite(pred)) and np.all(std > 0)
    np.testing.assert_array_equal(pred, npy(art(uv, xv, BETAS, seed=5)[0]))


def test_extrap_export_x_is_u_matches_jax():
    """test_export.py:454, and its replicates on K5's counts."""
    art = port("extrap_pipeline", order=3, beta0=1.0, x_is_u=True, **F64)
    jart = jaxa("extrap_pipeline", order=3, beta0=1.0, x_is_u=True, **F64)
    run = tpipe.make_extrap_pipeline(3, 1.0, x_is_u=True)
    for r in (257, 64):
        uv, _ = _data(r)
        got = npy(art(uv, BETAS))
        assert got.shape == (3,)
        np.testing.assert_allclose(got, np.asarray(jart(uv, BETAS)), rtol=1e-10)
        np.testing.assert_allclose(got, npy(run(uv, BETAS)), rtol=1e-10)
    from thermoextrap_tpu_torch.models.derivatives import central_u_ave_coefs
    from thermoextrap_tpu_torch.models.extrap import _poly_eval

    art_b = port("extrap_pipeline", order=3, beta0=1.0, x_is_u=True, nrep=16, **F64)
    uv, _ = _data(300)
    _pred, std = art_b(uv, BETAS, seed=4)
    bu, bdu = mc.resample_umoments_poisson_plain(tt(uv)[None], None, 16, 4, seed=4)[:2]
    want = _poly_eval(central_u_ave_coefs(bu[:, 0], bdu[..., 0], 3), tt(BETAS) - 1.0).std(dim=1, correction=0)
    np.testing.assert_allclose(npy(std), npy(want), rtol=1e-12)


def test_bucketed_runner_x_is_u():
    """test_export.py:494."""
    art = port("extrap_pipeline", order=3, beta0=1.0, x_is_u=True, weighted=True)
    serve = se.bucketed_runner(art, buckets=(64, 256))
    uv, _ = _data(50)
    got = npy(serve(uv, BETAS))
    np.testing.assert_allclose(got, npy(art(uv, BETAS, weight=np.ones(50))), rtol=1e-6, atol=1e-6)
    assert got.shape == (3,)


def _mbar_problem(n=2000):
    rng = np.random.default_rng(3)
    sig = np.array([1.0, 1.6, 2.5])
    xs = np.concatenate([rng.normal(0, s, n) for s in sig])
    u_kn = xs[None, :] ** 2 / (2 * sig[:, None] ** 2)
    return xs, u_kn, np.full(3, float(n))


@pytest.mark.parametrize("method", ["hybrid", "sci"])
def test_mbar_export_matches_solver(tmp_path, method):
    """test_export.py:506: the while_loop solve and the α scan against the
    in-process solver and grid and the JAX artifact; a file round trip
    serves another (N, A, V)."""
    xs, u_kn, n_k = _mbar_problem()
    alphas = np.linspace(0.4, 1.3, 13)  # not chunk-aligned
    x_n = np.stack([xs, xs**2], 1)
    art = port("mbar_reweighter", k_states=3, method=method, **F64)
    f, res, out = (npy(a) for a in art(u_kn, n_k, alphas, u_kn[0], x_n))
    f0, _it, res0 = tmbar.mbar_solve_info(u_kn, n_k, method=method)
    want = tmbar.mbar_expectations_grid(u_kn, n_k, f0, alphas[:, None] * u_kn[0][None, :], x_n)
    np.testing.assert_allclose(f, npy(f0), atol=1e-11)
    np.testing.assert_allclose(out, npy(want), rtol=1e-9)
    assert float(res) < 1e-10 or method == "sci"
    np.testing.assert_allclose(float(res), float(res0), rtol=1e-6, atol=1e-15)
    jf, _jres, jout = jaxa("mbar_reweighter", k_states=3, method=method, **F64)(u_kn, n_k, alphas, u_kn[0], x_n)
    np.testing.assert_allclose(f, np.asarray(jf), atol=1e-11)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-9)
    path = tmp_path / "mbar.bin"
    art.save(path)
    art2 = se.load_exported(path)
    assert art2.meta["family"] == "mbar"
    m = 3 * 2000 - 7
    _f3, _, out3 = art2(u_kn[:, :m], n_k, np.linspace(0.5, 1.0, 5), u_kn[0, :m], xs[:m] ** 2)
    assert npy(out3).shape == (5,)
    assert np.all(np.isfinite(npy(out3)))
    with pytest.raises(ValueError, match="K=3"):
        art2(u_kn[:2], n_k[:2], alphas, u_kn[0], x_n)


def test_mbar_export_guards():
    """test_export.py:506's argument checks: K >= 2 and a known method."""
    with pytest.raises(ValueError, match="k_states"):
        se.export_mbar_reweighter(1)
    with pytest.raises(ValueError, match="method"):
        se.export_mbar_reweighter(3, method="newton")


def test_volume_export_matches_jax(tmp_path):
    """test_export.py:548."""
    rng = np.random.default_rng(3)
    r = 257
    wv = 1.0 + 0.4 * rng.normal(size=r)
    xv = 0.5 + 0.3 * wv[:, None] + 0.2 * rng.normal(size=(r, 2))
    dxdqv = 0.1 * xv + 0.05 * rng.normal(size=(r, 2))
    vols = np.array([1.8, 2.0, 2.3])
    art = port("volume_pipeline", volume0=2.0, ndim=3, **F64)
    assert set(art.platforms) == {"cpu", "cuda"}
    got = npy(art(wv, xv, dxdqv, vols))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, np.asarray(jaxa("volume_pipeline", volume0=2.0, ndim=3, **F64)(wv, xv, dxdqv, vols)), rtol=1e-10)
    np.testing.assert_allclose(got, npy(tpipe.make_volume_pipeline(2.0, ndim=3)(wv, xv, dxdqv, vols)), rtol=1e-10)
    assert npy(art(wv[:64], xv[:64, 0], dxdqv[:64, 0], vols)).shape == (3,)
    art_b = port("volume_pipeline", volume0=2.0, ndim=3, nrep=50, weighted=True)
    w = rng.uniform(0.5, 1.5, r)
    pred, std = art_b(wv, xv, dxdqv, vols, weight=w)
    assert np.all(npy(std) > 0)
    path = tmp_path / "vol.bin"
    art_b.save(path)
    pred2, std2 = se.load_exported(path)(wv, xv, dxdqv, vols, weight=w)
    np.testing.assert_array_equal(npy(pred), npy(pred2))
    np.testing.assert_array_equal(npy(std), npy(std2))
    with pytest.raises(ValueError, match="weight"):
        art(wv, xv, dxdqv, vols, weight=w)
    with pytest.raises(ValueError, match="must match"):
        art(wv, xv, dxdqv[:, :1], vols)


def test_describe_artifact_and_cli(tmp_path):
    """test_export.py:637: the header alone, of the port's and of a JAX
    artifact (the shared contract); one JSON line per file from the CLI."""
    art = port("extrap_pipeline", order=2, beta0=1.0, nrep=8)
    p1 = tmp_path / "a.bin"
    art.save(p1)
    bundle = se.export_streaming_volume_pipeline(2.0, ndim=3)
    p2 = tmp_path / "b.bin"
    bundle.save(p2)
    d1 = se.describe_artifact(p1)
    assert d1["family"] == "extrap" and d1["kind"] == "batch" and d1["format"] == "torch"
    assert d1["nrep"] == 8 and d1["file_bytes"] > 0
    d2 = se.describe_artifact(p2)
    assert d2["family"] == "streaming_volume" and d2["kind"] == "streaming"
    assert "_sizes" not in d2 and "_state_spec" not in d2
    p3 = tmp_path / "jax.bin"
    jaxa("extrap_pipeline", order=2, beta0=1.0).save(p3)
    d3 = se.describe_artifact(p3)
    assert d3["format"] == "jax" and d3["family"] == "extrap" and d3["order"] == 2
    assert {k for k in d3 if k != "format"} == {k for k in jse.describe_artifact(p3)}
    with pytest.raises(ValueError, match="not a thermoextrap_tpu"):
        bad = tmp_path / "bad.bin"
        bad.write_bytes(b"nope\n{}\n")
        se.describe_artifact(bad)
    out = subprocess.run(
        [sys.executable, "-m", "thermoextrap_tpu_torch.serving_export", str(p1), str(p2)],
        capture_output=True,
        text=True,
        check=True,
        cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    assert len(lines) == 2
    assert json.loads(lines[0])["family"] == "extrap"
    assert json.loads(lines[1])["family"] == "streaming_volume"


def test_perturb_export_matches_jax(tmp_path):
    """test_export.py:675: the prediction against the JAX artifact and the
    port's pipeline; the replicates are K8's plain sums on its counts at the
    call's seed, and statistically the JAX artifact's."""
    nrep = 256
    art = port("perturb_pipeline", beta0=1.0, nrep=nrep, **F64)
    jart = jaxa("perturb_pipeline", beta0=1.0, nrep=nrep, **F64)
    run = tpipe.make_perturb_pipeline(1.0)
    from thermoextrap_tpu_torch.pipeline import _perturb_weights

    for r in (257, 96):
        uv, xv = _data(r)
        pred, std = (npy(a) for a in art(uv, xv, BETAS, seed=9))
        jpred, jstd = (np.asarray(a) for a in jart(uv, xv, BETAS, seed=9))
        np.testing.assert_allclose(pred, jpred, rtol=1e-10)
        np.testing.assert_allclose(pred, npy(run(uv, xv, BETAS)), rtol=1e-10)
        e = _perturb_weights(tt(uv), tt(BETAS) - 1.0, None)
        s = mc.resample_perturb_poisson_plain(e, tt(xv), nrep, seed=9)
        np.testing.assert_allclose(std, npy((s[..., :2] / s[..., 2:]).std(dim=1, correction=0)), rtol=1e-12)
        ratio = std / jstd
        assert np.all((ratio > 0.7) & (ratio < 1.4)), ratio
    path = tmp_path / "perturb.thexport"
    art.save(path)
    art2 = se.load_exported(path)
    assert art2.meta["family"] == "perturb"
    uv, xv = _data(128)
    np.testing.assert_array_equal(npy(art(uv, xv, BETAS, seed=1)[0]), npy(art2(uv, xv, BETAS, seed=1)[0]))


def test_perturb_export_weighted_and_guards():
    """test_export.py:702."""
    art_w = port("perturb_pipeline", beta0=1.0, weighted=True, **F64)
    uv, xv = _data(200)
    w = np.random.default_rng(3).uniform(0.5, 2.0, 200)
    got = npy(art_w(uv, xv, BETAS, weight=w))
    np.testing.assert_allclose(got, np.asarray(jaxa("perturb_pipeline", beta0=1.0, weighted=True, **F64)(uv, xv, BETAS, weight=w)), rtol=1e-10)
    np.testing.assert_allclose(got, npy(tpipe.make_perturb_pipeline(1.0, weighted=True)(uv, xv, BETAS, w)), rtol=1e-10)
    with pytest.raises(ValueError, match="weighted=True"):
        art_w(uv, xv, BETAS)
    art_u = port("perturb_pipeline", beta0=1.0)
    with pytest.raises(ValueError, match="no weight operand"):
        art_u(uv, xv, BETAS, weight=w)
    assert npy(art_u(uv, xv[:, 0], BETAS)).shape == (3,)


def test_bucketed_runner_perturb_and_volume():
    """test_export.py:720."""
    art_p = port("perturb_pipeline", beta0=1.0, weighted=True)
    serve_p = se.bucketed_runner(art_p, buckets=[64, 256])
    uv, xv = (a.astype(np.float32) for a in _data(100))
    np.testing.assert_allclose(npy(serve_p(uv, xv, BETAS)), npy(art_p(uv, xv, BETAS, weight=np.ones(100))), rtol=2e-6, atol=2e-6)
    art_v = port("volume_pipeline", volume0=2.0, ndim=3, weighted=True)
    serve_v = se.bucketed_runner(art_v, buckets=[64, 256])
    rng = np.random.default_rng(5)
    wv = rng.normal(size=100).astype(np.float32)
    xv2 = rng.normal(size=(100, 2)).astype(np.float32)
    dx = rng.normal(size=(100, 2)).astype(np.float32)
    vols = np.array([1.9, 2.1])
    want = npy(art_v(wv, xv2, dx, vols, weight=np.ones(100)))
    np.testing.assert_allclose(npy(serve_v(wv, xv2, dx, vols)), want, rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError, match="weighted=True"):
        se.bucketed_runner(port("perturb_pipeline", beta0=1.0))


def test_platforms_are_checked():
    """An artifact runs only on the platforms it was exported for."""
    with pytest.raises(ValueError, match="platforms"):
        se.export_extrap_pipeline(2, 1.0, platforms=("tpu",))
    art = se.export_extrap_pipeline(2, 1.0, platforms=("cuda",))
    uv, xv = _data(8)
    with pytest.raises(ValueError, match="not cpu"):
        art(uv, xv, BETAS)


# -- the frozen GPR predictor (tests/test_gpr_serving.py:269-292) ----------------------------


@pytest.fixture(scope="module")
def trained():
    from thermoextrap_tpu_torch.gpr_active.gp_models import HeteroscedasticGPR
    from thermoextrap_tpu_torch.gpr_active.kernels import RBFDerivKernel

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 2 * np.pi, 8)
    y0 = np.sin(xs) + rng.normal(0, 0.02, xs.shape)
    y1 = np.cos(xs) + rng.normal(0, 0.05, xs.shape)
    x = np.concatenate([np.stack([xs, np.zeros_like(xs)], 1), np.stack([xs, np.ones_like(xs)], 1)])
    y = np.concatenate([y0, y1])[:, None]
    cov = np.diag(np.concatenate([np.full_like(xs, 4e-4), np.full_like(xs, 2.5e-3)]))
    model = HeteroscedasticGPR((x, y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    model.train()
    yield model
    torch.set_num_threads(n)


XT = np.linspace(0.5, 5.5, 11)


def test_gpr_export_roundtrip_polymorphic_m(trained, tmp_path):
    """test_gpr_serving.py:269."""
    art = se.export_gpr_predictor(trained, dtype=torch.float64)
    assert art.meta["family"] == "gpr"
    path = tmp_path / "gpr.bin"
    art.save(path)
    art2 = se.load_exported(path)
    xt = np.stack([XT, np.zeros_like(XT)], 1)
    mean_ref, var_ref = (npy(a) for a in trained.predict_f(xt))
    mean, var = (npy(a) for a in art2(XT))
    np.testing.assert_allclose(mean, mean_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var, var_ref, rtol=1e-7, atol=1e-12)
    m5, v5 = (npy(a) for a in art2(XT[:5]))
    np.testing.assert_allclose(m5, mean[:5], rtol=1e-8)
    np.testing.assert_allclose(v5, var[:5], rtol=1e-7, atol=1e-12)


def test_gpr_export_matches_frozen_f32(trained):
    """test_gpr_serving.py:286: the float32 artifact equals
    ``freeze_predictor`` to the bit."""
    from thermoextrap_tpu_torch.gpr_active.serving import freeze_predictor

    art = se.export_gpr_predictor(trained)
    pred = freeze_predictor(trained)
    mean_a, var_a = (npy(a) for a in art(XT))
    mean_p, var_p = (npy(a) for a in pred(XT))
    np.testing.assert_array_equal(mean_a, mean_p)
    np.testing.assert_array_equal(var_a, var_p)

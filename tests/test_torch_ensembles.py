"""The ensembles slice of the torch port against the JAX package: the
batched u-moment kernels' plain versions (K4, K5), the x_is_u dispatch
route, the ⟨u⟩ / lnΠ / volume pipelines, the lnΠ and volume models, the
golden lnΠ data, raw-moment constructors, the ideal-gas oracle's new
helpers and the lnΠ state carried across packages.

Inputs are numpy arrays made from a seed; the JAX side runs on the CPU in
float64 (tests/conftest.py), its Pallas kernels in interpret mode.  Bars:
float64 parity rtol 1e-10 (the tolerance tests/test_pipeline.py uses);
float32 kernels against float64 at the bars of tests/test_parallel.py:158-161
(uave rtol 1e-6; du rtol 5e-3, atol 1e-4); bootstrap CIs from different
random tables within Monte-Carlo error.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import idealgas as jideal
from thermoextrap_tpu import lnpi as jlnpi
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu import volume as jvolume
from thermoextrap_tpu import volume_idealgas as jvolume_ig
from thermoextrap_tpu.ops import moments as jmoments
from thermoextrap_tpu.ops import moments_pallas as jpallas
from thermoextrap_tpu.ops import resample as jresample
from thermoextrap_tpu.utils.trees import replace as jreplace
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import idealgas as tideal
from thermoextrap_tpu_torch import interop
from thermoextrap_tpu_torch import lnpi as tlnpi
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch import volume as tvolume
from thermoextrap_tpu_torch import volume_idealgas as tvolume_ig
from thermoextrap_tpu_torch.ops import dispatch
from thermoextrap_tpu_torch.ops import moments_cuda as mc

RTOL = 1e-10
ATOL = 1e-13
GOLDEN = Path(__file__).parent / "lnpi_data" / "sample_data.json"


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _two_pass_u(u, w, order):
    """Reference central u-moments of each row, numpy float64."""
    w = np.ones_like(u) if w is None else np.broadcast_to(w, u.shape)
    wsum = w.sum(-1)
    ubar = (w * u).sum(-1) / wsum
    d = u - ubar[..., None]
    du = np.stack([(w * d**n).sum(-1) / wsum for n in range(order + 1)])
    du[0], du[1] = 1.0, 0.0
    return ubar, du


def _grid(rng, n_grid, r, order_shift=1.0):
    """Per-macrostate energy streams with a grid-dependent mean."""
    return np.linspace(-2.0, 2.0, n_grid)[:, None] * order_shift + rng.normal(-10.0, 1.5, (n_grid, r))


# -- K4 plain version -----------------------------------------------------------------


def test_k4_plain_matches_jax_kernel(rng):
    """tests/test_parallel.py:138: shapes, weights and bars."""
    order, b, r = 5, 3, 2500
    u = rng.normal(-50.0, 2.0, (b, r)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (b, r)).astype(np.float32)
    juave, jdu = jpallas.reduce_central_umoments_batched(u, order, weight=w, interpret=True)
    tuave, tdu = mc.reduce_central_umoments_batched(tt(u).double(), order, tt(w).double())
    assert tuave.shape == (b,) and tdu.shape == (order + 1, b)
    assert_close(tuave, juave, 1e-6)
    assert_close(tdu, jdu, 5e-3, 1e-4)
    # float32 inputs compute in float32 and hold the same bar
    f32 = mc.reduce_central_umoments_batched(tt(u), order, tt(w))
    assert f32[0].dtype == torch.float32
    assert_close(f32[0], juave, 1e-6)
    assert_close(f32[1], jdu, 5e-3, 1e-4)


@pytest.mark.parametrize("case", ["unweighted", "weighted", "zero_head"])
def test_k4_plain_matches_two_pass(rng, case):
    """float64: the head shift and the exact recentring agree with the
    two-pass form to roundoff; R = 12001 is no multiple of 128, and a head of
    zero weight (9000 > 8192 samples) falls back to shift 0."""
    order, r = 6, 12001
    u = rng.normal(5.0, 1.0, (4, r))
    w = None if case == "unweighted" else rng.uniform(0.5, 1.5, (4, r))
    if case == "zero_head":
        w[:, :9000] = 0.0
    uave, du = mc.reduce_central_umoments_batched(tt(u), order, None if w is None else tt(w))
    ref_u, ref_du = _two_pass_u(u, w, order)
    assert_close(uave, ref_u, RTOL)
    assert_close(du, ref_du, RTOL, ATOL)
    # the plain two-pass of the port agrees too
    pu, pdu = tx.ops.moments.reduce_central_umoments(tt(u), order, None if w is None else tt(w))
    assert_close((pu, pdu), (ref_u, ref_du), RTOL, ATOL)


def test_k4_shapes(rng):
    u = rng.normal(1.0, 0.5, (2, 3, 500))
    uave, du = mc.reduce_central_umoments_batched(tt(u), 4)
    assert uave.shape == (2, 3) and du.shape == (5, 2, 3)
    flat_u, flat_du = mc.reduce_central_umoments_batched(tt(u[0, 1]), 4)
    assert flat_u.shape == () and flat_du.shape == (5,)
    assert_close((flat_u, flat_du), (uave[0, 1], du[:, 0, 1]), RTOL, ATOL)
    _, _, wsum = mc.reduce_umoments_plain(tt(u[0]), None, 3)
    assert_close(wsum, np.full(3, 500.0), 0.0)


# -- K5 plain versions ----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_k5_table_plain_matches_jax(rng, weighted):
    """K5's consume on a count table against the JAX table bootstrap."""
    order, nbatch, r, nrep = 5, 4, 1000, 9
    u = _grid(rng, nbatch, r)
    w = rng.uniform(0.5, 1.5, (nbatch, r)) if weighted else None
    freq = np.asarray(jresample.freq_from_indices(rng.integers(0, r, (nrep, r)), r))
    ju, jdu = jresample.resample_central_umoments_batched(u, freq, order, weight=w)
    tu, tdu, twsum = mc.resample_umoments_plain(tt(u), None if w is None else tt(w), tt(freq), order)
    assert tu.shape == (nrep, nbatch) and tdu.shape == (order + 1, nrep, nbatch)
    assert_close((tu, tdu), (ju, jdu), RTOL, ATOL)
    ref_wsum = freq @ (np.ones_like(u) if w is None else w).T
    assert_close(twsum, ref_wsum, RTOL)
    # and the port's own table bootstrap of the CPU path
    pu, pdu = tx.ops.resample.resample_central_umoments_batched(
        tt(u), tt(freq), order, None if w is None else tt(w)
    )
    assert_close((pu, pdu), (ju, jdu), RTOL, ATOL)


def test_k5_poisson_plain_statistics(rng):
    """tests/test_parallel.py:658-713: counts shared by the batch rows
    (identical rows give identical replicates), sane bootstrap statistics,
    and the per-replicate weight within 6 sqrt(R) of R."""
    order, nbatch, r, nrep = 4, 3, 1024, 64
    base = rng.normal(2.0, 1.0, r)
    u = np.broadcast_to(base, (nbatch, r)).copy()
    uave, du = mc.resample_central_umoments_batched_poisson(tt(u), nrep, order, seed=7)
    assert uave.shape == (nrep, nbatch) and du.shape == (order + 1, nrep, nbatch)
    for b in range(1, nbatch):
        assert torch.equal(uave[:, b], uave[:, 0])
        assert torch.equal(du[:, :, b], du[:, :, 0])
    np.testing.assert_allclose(float(uave[:, 0].mean()), base.mean(), atol=0.15)
    np.testing.assert_allclose(float(du[2, :, 0].mean()), base.var(), rtol=0.2)
    assert float(uave[:, 0].std()) > 1e-4
    uw, duw, wsum = mc.resample_central_umoments_batched_poisson(tt(u), nrep, order, seed=7, return_wsum=True)
    assert torch.equal(uw, uave) and torch.equal(duw, du)
    assert wsum.shape == (nrep, nbatch)
    assert bool((wsum[:, 1:] == wsum[:, :1]).all())
    assert bool(((wsum[:, 0] - r).abs() < 6 * r**0.5).all())


def test_k5_poisson_plain_uses_k3_counts(rng):
    """K5's plain version consumes _poisson_counts (the table K3 draws) in
    chunks, equal to its table version on the whole table; on one row its
    per-replicate weight equals K3's at the same seed."""
    order, nbatch, r, nrep = 3, 2, 5003, 11
    u = _grid(rng, nbatch, r)
    w = rng.uniform(0.5, 1.5, (nbatch, r))
    table = mc._poisson_counts(5, nrep, r)
    got = mc.resample_umoments_poisson_plain(tt(u), tt(w), nrep, order, seed=5, chunk=1000)
    assert_close(got, mc.resample_umoments_plain(tt(u), tt(w), table, order), 1e-12, ATOL)
    _, _, wsum5 = mc.resample_umoments_poisson_plain(tt(u[:1]), None, nrep, order, seed=5)
    k3 = mc.resample_central_comoments_poisson(tt(u[0]), tt(u[0])[:, None], nrep, order, seed=5, return_wsum=True)
    assert torch.equal(wsum5[:, 0], k3[4])


# -- the x_is_u dispatch route ---------------------------------------------------------


def test_x_is_u_dispatch_contract(rng):
    """tests/test_parallel.py:954-987: the u-only route (K4 at order + 1,
    shift view dxdu[n] = du[n+1]) against the comoment reduction of (u, u),
    on the kernel route (forced "cuda": K4's plain version here) and on the
    plain route."""
    order, r = 4, 3000
    u = rng.normal(5.0, 1.0, r).astype(np.float32)
    ref = jmoments.reduce_central_comoments(np.float64(u), np.float64(u), order, val_ndim=0)
    juave, jdu = jpallas.reduce_central_umoments_batched(u, order + 1, interpret=True)
    assert_close(juave, ref[1], 1e-5)
    for impl in ("cuda", None):
        with dispatch.use_impl(impl):
            got = dispatch.reduce_central(tt(u).double(), tt(u).double(), order, x_is_u=True, val_ndim=0)
        assert all(g.shape == np.shape(e) for g, e in zip(got, ref))
        assert_close(got, ref, RTOL, ATOL)
        # the JAX float32 kernel's shift view holds its own bar
        assert_close(got[2], np.asarray(jdu)[: order + 1], 2e-3, 1e-5)
        assert_close(got[3], np.asarray(jdu)[1 : order + 2], 2e-3, 1e-4)
    # x_is_u values data resampled by index goes through the batched route
    idx = rng.integers(0, r, (5, r))
    data = tx.factory_data_values(uv=tt(u).double(), xv=None, order=order, central=True)
    plain = data.resample({"indices": tt(idx)})
    with dispatch.use_impl("cuda"):
        routed = data.resample({"indices": tt(idx)})
        assert_close((routed.uave, routed.du), (plain.uave, plain.du), RTOL, ATOL)


# -- pipelines ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "weighted", "minus_log"])
def test_u_pipeline_matches_jax(rng, variant):
    """make_extrap_pipeline(x_is_u=True) at nrep = 0."""
    order, r = 5, 3000
    u = rng.normal(3.0, 0.7, r)
    kw = {"weighted": variant == "weighted", "minus_log": variant == "minus_log"}
    betas = np.array([0.8, 1.0, 1.3])
    jargs, targs = [u, betas], [tt(u), tt(betas)]
    if variant == "weighted":
        w = rng.uniform(0.5, 1.5, r)
        jargs.append(w)
        targs.append(tt(w))
    got = tpipe.make_extrap_pipeline(order, 1.0, x_is_u=True, **kw)(*targs)
    assert_close(got, jpipe.make_extrap_pipeline(order, 1.0, x_is_u=True, **kw)(*jargs), RTOL, ATOL)


def test_u_pipeline_ci_within_monte_carlo_error(rng):
    order, r, nrep = 4, 4000, 200
    u = rng.normal(3.0, 0.7, r)
    betas = np.array([0.8, 1.3])
    tpred, tstd = tpipe.make_extrap_pipeline(order, 1.0, x_is_u=True, nrep=nrep)(tt(u), tt(betas), seed=1)
    jpred, jstd = jpipe.make_extrap_pipeline(order, 1.0, x_is_u=True, nrep=nrep)(u, betas, seed=1)
    assert_close(tpred, jpred, RTOL, ATOL)
    # the relative spread of a std from nrep replicates is ~1/sqrt(2 nrep) = 5%
    np.testing.assert_allclose(npy(tstd), np.asarray(jstd), rtol=0.25)


def test_lnpi_pipeline_matches_jax_and_model(rng):
    """tests/test_pipeline.py:137-169: the one-call grid pipeline equals the
    JAX pipeline and the moment-backed model built from raw moments."""
    order, beta0, n_grid, r = 3, 1.4, 7, 3000
    uv = _grid(rng, n_grid, r)
    lnpi0 = rng.normal(0.0, 1.0, n_grid)
    lnpi0 -= lnpi0[0]
    mu = 0.7
    ncoords = np.arange(n_grid, dtype=float)
    betas = np.array([1.2, 1.4, 1.6])
    got = tpipe.make_lnpi_pipeline(order, beta0)(tt(uv), tt(lnpi0), tt(mu * ncoords), tt(betas))
    assert got.shape == (3, n_grid) and got.dtype == torch.float64
    assert_close(got, jpipe.make_lnpi_pipeline(order, beta0)(uv, lnpi0, mu * ncoords, betas), RTOL, ATOL)
    u_raw = np.stack([(uv**n).mean(axis=-1) for n in range(order + 1)])
    data = tx.DataCentralMoments.from_ave_raw(u=u_raw, xu=None, x_is_u=True, central=True)
    meta = tlnpi.lnPiDataCallback.from_mu(lnPi0=lnpi0, mu=[mu], ncoords=ncoords[None, :])
    model = tlnpi.factory_extrapmodel_lnPi(beta0, tx.data.dataclasses.replace(data, meta=meta))
    assert_close(got, model.predict(tt(betas)), 1e-8, 1e-10)
    # the forced kernel route (K4's plain version on the CPU) agrees
    with dispatch.use_impl("cuda"):
        routed = tpipe.make_lnpi_pipeline(order, beta0)(tt(uv), tt(lnpi0), tt(mu * ncoords), tt(betas))
    assert_close(routed, got, RTOL, ATOL)
    with pytest.raises(ValueError, match="order must be >= 1"):
        tpipe.make_lnpi_pipeline(0, beta0)


def test_lnpi_pipeline_bootstrap_std(rng):
    """tests/test_pipeline.py:185-207, and the CI agrees with the JAX one
    within Monte-Carlo error."""
    order, beta0, n_grid, r, nrep = 3, 1.4, 5, 2000, 200
    uv = _grid(rng, n_grid, r, 0.5)
    lnpi0 = rng.normal(0.0, 1.0, n_grid)
    mudotn = 0.7 * np.arange(n_grid, dtype=float)
    betas = np.array([1.2, 1.6])
    pred0 = tpipe.make_lnpi_pipeline(order, beta0)(tt(uv), tt(lnpi0), tt(mudotn), tt(betas))
    pred, std = tpipe.make_lnpi_pipeline(order, beta0, nrep=nrep)(tt(uv), tt(lnpi0), tt(mudotn), tt(betas), seed=1)
    assert_close(pred, pred0, 1e-12)
    assert std.shape == pred.shape
    assert bool((std > 0).all()) and bool((std < 1.0).all())
    _, jstd = jpipe.make_lnpi_pipeline(order, beta0, nrep=nrep)(uv, lnpi0, mudotn, betas, seed=1)
    np.testing.assert_allclose(npy(std), np.asarray(jstd), rtol=0.25)


@pytest.mark.parametrize("weighted", [False, True])
def test_volume_pipeline_matches_jax(rng, weighted):
    r = 4000
    pos = -np.log(1.0 - rng.uniform(size=(r, 10)) * (1.0 - np.exp(-1.0)))
    x = pos.mean(-1)
    wv = -pos.sum(-1)
    xv = np.stack([x, x**2], 1)
    vols = np.array([0.9, 1.0, 1.1])
    jargs = [wv, xv, xv, vols]
    targs = [tt(wv), tt(xv), tt(xv), tt(vols)]
    if weighted:
        w = rng.uniform(0.5, 1.5, r)
        jargs.append(w)
        targs.append(tt(w))
    got = tpipe.make_volume_pipeline(1.0, ndim=1, weighted=weighted)(*targs)
    assert got.shape == (3, 2)
    assert_close(got, jpipe.make_volume_pipeline(1.0, ndim=1, weighted=weighted)(*jargs), RTOL, ATOL)
    pred, std = tpipe.make_volume_pipeline(1.0, ndim=1, weighted=weighted, nrep=200)(*targs, seed=3)
    assert_close(pred, got, RTOL, ATOL)
    _, jstd = jpipe.make_volume_pipeline(1.0, ndim=1, weighted=weighted, nrep=200)(*jargs, seed=3)
    np.testing.assert_allclose(npy(std), np.asarray(jstd), rtol=0.25)
    with pytest.raises(ValueError, match="must match"):
        tpipe.make_volume_pipeline(1.0)(tt(wv), tt(x), tt(xv), tt(vols))


# -- volume models (tests/test_volume.py) ---------------------------------------------


@pytest.fixture(scope="module")
def ig_volume_data():
    rng = np.random.default_rng(12)
    pos = -np.log(1.0 - rng.uniform(size=(40_000, 100)) * (1.0 - np.exp(-1.0)))
    x = pos.mean(axis=-1)  # observable: mean position
    # virial = -sum_i q_i dU/dq_i = -U for the linear field; uv = beta * virial
    return x, -pos.sum(axis=-1)


def test_ig_module_first_order(ig_volume_data):
    x, w = ig_volume_data
    model = tvolume_ig.factory_extrapmodel(1.0, uv=tt(w), xv=tt(x))
    derivs = npy(model.derivs())
    assert abs(derivs[0] - float(tideal.x_ave(1.0, 1.0))) < 5e-3
    assert abs(derivs[1] - float(tideal.dvol_xave(1)(1.0, 1.0))) < 5e-2
    vols = np.array([0.8, 1.2])
    exact = np.array([float(tideal.x_vol_extrap(1, 1.0, v, 1.0)[0]) for v in vols])
    np.testing.assert_allclose(npy(model.predict(tt(vols))), exact, atol=5e-2)
    jmodel = jvolume_ig.factory_extrapmodel(1.0, uv=w, xv=x)
    assert_close(model.predict(tt(vols)), jmodel.predict(vols), RTOL, ATOL)


def test_general_volume_matches_ig_variant(ig_volume_data):
    x, w = ig_volume_data
    m_gen = tvolume.factory_extrapmodel(1.0, uv=tt(w), xv=tt(x), dxdqv=tt(x), ndim=1)
    m_ig = tvolume_ig.factory_extrapmodel(1.0, uv=tt(w), xv=tt(x))
    assert_close(m_gen.derivs(), m_ig.derivs(), 1e-12)
    jm = jvolume.factory_extrapmodel(1.0, uv=w, xv=x, dxdqv=x, ndim=1)
    assert_close(m_gen.derivs(), jm.derivs(), RTOL, ATOL)


def test_volume_resample(ig_volume_data):
    x, w = ig_volume_data
    model = tvolume.factory_extrapmodel(1.0, uv=tt(w[:5000]), xv=tt(x[:5000]), dxdqv=tt(x[:5000]), ndim=1)
    idx = np.random.default_rng(4).integers(0, 5000, (8, 5000))
    pred = npy(model.resample({"indices": tt(idx)}).predict(1.1))
    assert pred.shape == (8,)
    exact = float(tideal.x_vol_extrap(1, 1.0, 1.1, 1.0)[0])
    assert abs(pred.mean() - exact) < 10 * pred.std() + 5e-2
    jm = jvolume.factory_extrapmodel(1.0, uv=w[:5000], xv=x[:5000], dxdqv=x[:5000], ndim=1)
    assert_close(pred, jm.resample({"indices": idx}).predict(1.1), RTOL, ATOL)
    with pytest.raises(NotImplementedError, match="index-style"):
        model.data.meta.resample(model.data, freq=tt(idx))


def test_ig_factory_extrapmodel_data(ig_volume_data):
    x, w = ig_volume_data
    data = tx.factory_data_values(uv=tt(w), xv=tt(x), order=1, central=False, xalpha=False)
    m_data = tvolume_ig.factory_extrapmodel_data(1.0, data)
    m_vals = tvolume_ig.factory_extrapmodel(1.0, uv=tt(w), xv=tt(x))
    assert_close(m_data.predict(tt([0.9, 1.1])), m_vals.predict(tt([0.9, 1.1])), 1e-12)
    central = tx.factory_data_values(uv=tt(w), xv=tt(x), order=1, central=True)
    with pytest.raises(ValueError, match="raw moments"):
        tvolume_ig.factory_extrapmodel_data(1.0, central)
    with pytest.raises(ValueError, match="1st order"):
        tvolume.VolumeDerivFuncs()[2]


# -- lnΠ: golden data, constructors, interop ------------------------------------------


@pytest.fixture(scope="module")
def golden():
    """tests/lnpi_data/sample_data.json, read in place (tests/test_lnpi_golden.py)."""
    d = json.loads(GOLDEN.read_text())

    def prep(x):
        lnpi = np.array(x["lnPi"])
        energy = np.array(x["energy"])  # (n, umom 1..3)
        energy = np.concatenate([np.ones_like(energy[:, :1]), energy], axis=-1)  # include umom=0
        return {"lnpi": lnpi - lnpi[0], "energy": energy, "mu": x["mu"], "beta": x["beta"], "order": x["order"]}

    return prep(d["ref"]), [prep(s) for s in d["samples"]]


@pytest.mark.parametrize("central", [False, True], ids=["raw", "central"])
def test_golden_u_extrapolation(golden, central):
    ref, samples = golden
    data = tx.DataCentralMoments.from_ave_raw(u=ref["energy"].T, xu=None, x_is_u=True, central=central)
    model = tbeta.factory_extrapmodel(beta=ref["beta"], data=data, name="u_ave")
    for s in samples:
        pred = npy(model.predict(s["beta"], cumsum=True))  # (order+1, n)
        if s["order"] <= model.order:
            np.testing.assert_allclose(pred[s["order"]], s["energy"][:, 1], rtol=1e-5)


@pytest.mark.parametrize("central", [False, True], ids=["raw", "central"])
def test_golden_lnpi_extrapolation(golden, central):
    ref, samples = golden
    meta = tlnpi.lnPiDataCallback.from_mu(
        lnPi0=ref["lnpi"], mu=[ref["mu"]], ncoords=np.arange(len(ref["lnpi"]), dtype=float)[None, :]
    )
    data = tx.DataCentralMoments.from_ave_raw(u=ref["energy"].T, xu=None, x_is_u=True, central=central, meta=meta)
    model = tlnpi.factory_extrapmodel_lnPi(beta=ref["beta"], data=data)
    for s in samples:
        pred = npy(model.predict(s["beta"], cumsum=True))  # (order+2, n)
        got = pred[s["order"]] - pred[s["order"], 0]
        np.testing.assert_allclose(got, s["lnpi"], rtol=1e-7, atol=1e-10)


def test_from_raw_matches_jax(rng):
    """x_is_u and x != u raw-moment constructors: the same fields as JAX."""
    fields = lambda d: (d.xave, d.uave, d.du, d.dxdu, d.wsum)  # noqa: E731
    u = rng.normal(1.0, 0.3, (3, 500))
    x = rng.normal(2.0, 0.5, (3, 500, 2))
    u_raw = np.stack([(u**n).mean(-1) for n in range(6)])
    xu_raw = np.stack([(x * u[..., None] ** n).mean(-2) for n in range(5)])
    jd = jx.DataCentralMoments.from_raw(u_raw, x_is_u=True, central=True)
    td = tx.DataCentralMoments.from_raw(tt(u_raw), x_is_u=True, central=True)
    assert td.order == jd.order == 4 and td.x_is_u
    assert_close(fields(td), fields(jd), 1e-12, ATOL)
    # float32 raw moments are converted in float64 on the host
    assert tx.DataCentralMoments.from_raw(tt(u_raw).float(), x_is_u=True).du.dtype == torch.float64
    jd2 = jx.DataCentralMoments.from_ave_raw(u_raw[:5], xu_raw, wsum=np.full(3, 500.0))
    td2 = tx.DataCentralMoments.from_ave_raw(u_raw[:5], xu_raw, wsum=np.full(3, 500.0))
    assert td2.val_ndim == jd2.val_ndim == 1
    assert_close(fields(td2), fields(jd2), 1e-12, ATOL)
    assert_close(
        tbeta.factory_extrapmodel(1.0, td2).predict(tt([0.9, 1.1])),
        jbeta.factory_extrapmodel(1.0, jd2).predict(np.array([0.9, 1.1])),
        1e-12,
        ATOL,
    )


def test_lnpi_callback_validation(rng):
    u = rng.normal(0.0, 1.0, (3, 200))
    meta = tlnpi.lnPiDataCallback.from_mu(tt([0.0, 0.1, 0.2]), 0.5, tt(np.arange(3.0)[None]))
    assert_close(meta.mudotN, 0.5 * np.arange(3.0), 0.0)
    data = tx.factory_data_values(uv=tt(u), xv=None, order=3, central=True, meta=meta)
    with pytest.raises(ValueError, match="allow_resample"):
        meta.resample(data, indices=tt(rng.integers(0, 200, (2, 200))))
    with pytest.raises(ValueError, match="must be <="):
        tlnpi.factory_extrapmodel_lnPi(1.0, data, order=5)
    with pytest.raises(ValueError, match="x_is_u"):
        tlnpi.factory_extrapmodel_lnPi(1.0, tx.factory_data_values(uv=tt(u), xv=tt(u), order=3, central=True))
    model = tlnpi.factory_extrapmodel_lnPi(1.0, data, order=0)
    assert_close(model.predict(tt([0.5, 1.5])), np.broadcast_to([0.0, 0.1, 0.2], (2, 3)), 0.0)
    assert tlnpi.factory_derivatives("u_ave", central=True).name == "beta:u_ave"


def test_interop_lnpi_round_trip(rng):
    """An x_is_u moment state with its lnΠ callback goes from numpy into both
    packages, and back, and predicts identically."""
    n_grid = 5
    uv = _grid(rng, n_grid, 800)
    u_raw = np.stack([(uv**n).mean(-1) for n in range(6)])
    lnpi0 = rng.normal(0.0, 1.0, n_grid)
    ncoords = np.arange(n_grid, dtype=float)[None, :]
    jmeta = jlnpi.lnPiDataCallback.from_mu(lnpi0, [0.7], ncoords)
    jd = jreplace(jx.DataCentralMoments.from_ave_raw(u=u_raw, x_is_u=True, central=True), meta=jmeta)
    state = interop.data_to_numpy(jd)
    assert set(interop.LNPI_FIELDS) <= set(state)
    td = interop.data_from_numpy(state, **{k: state[k] for k in interop.FLAGS})
    assert isinstance(td.meta, tlnpi.lnPiDataCallback) and td.x_is_u
    betas = np.array([1.2, 1.4, 1.6])
    jpred = jlnpi.factory_extrapmodel_lnPi(1.4, jd).predict(betas)
    assert_close(tlnpi.factory_extrapmodel_lnPi(1.4, td).predict(tt(betas)), jpred, 1e-12, ATOL)
    back = interop.data_to_numpy(td)
    jd2 = jx.DataCentralMoments(
        **{k: back[k] for k in interop.FIELDS},
        meta=jlnpi.lnPiDataCallback(back["lnPi0"], back["mudotN"], back["allow_resample"]),
        **{k: back[k] for k in interop.FLAGS},
    )
    assert_close(jlnpi.factory_extrapmodel_lnPi(1.4, jd2).predict(betas), jpred, 1e-12, ATOL)


# -- the ideal-gas oracle ------------------------------------------------------------


def test_idealgas_helpers_match_jax():
    xs = np.array([0.1, 0.5, 0.9])
    assert_close(tideal.x_prob(tt(xs), 1.3), jideal.x_prob(xs, 1.3), 1e-13)
    assert_close(tideal.x_cdf(tt(xs), 1.3, 2.0), jideal.x_cdf(xs, 1.3, 2.0), 1e-13)
    assert_close(tideal.u_prob(tt(xs * 10), 20, 1.3), jideal.u_prob(xs * 10, 20, 1.3), 1e-13)
    for name in ("x_beta_extrap_minuslog", "x_beta_extrap_depend", "x_beta_extrap_depend_minuslog"):
        assert_close(getattr(tideal, name)(4, 1.0, 1.2), getattr(jideal, name)(4, 1.0, 1.2), 1e-12, 1e-11)
    for k in range(3):
        assert_close(tideal.dvol_xave(k)(1.3, 0.8), jideal.dvol_xave(k)(1.3, 0.8), 1e-12)
    assert_close(tideal.x_vol_extrap(2, 1.0, 1.2, beta=5.6), jideal.x_vol_extrap(2, 1.0, 1.2, beta=5.6), 1e-12)

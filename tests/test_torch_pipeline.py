"""The β-extrapolation slice of the torch port end to end against the JAX
package: data factory → predict, resampling with the same numpy indices or
tables, the moment-backed container, the serving pipeline (nrep = 0 in
every variant, float64 rtol 1e-10), its bootstrap CI within Monte-Carlo
error, the moment state carried across packages, and the import boundary
(the port never imports jax)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import idealgas as jideal
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import idealgas as tideal
from thermoextrap_tpu_torch import interop
from thermoextrap_tpu_torch import pipeline as tpipe

RTOL = 1e-10
ATOL = 1e-13
BETA0 = 1.0
BETAS = np.array([0.8, 1.0, 1.3])


def _ideal_gas(seed, nconfig, npart=20):
    """Ideal-gas samples made with numpy: (x mean per config, u per config)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=(nconfig, npart))
    pos = -np.log(1.0 - r * (1.0 - np.exp(-BETA0))) / BETA0
    return pos.mean(-1), pos.sum(-1)


@pytest.fixture
def gas():
    return _ideal_gas(5, 2000)


# -- data + model ------------------------------------------------------------------


@pytest.mark.parametrize(("central", "minus_log", "order"), [(True, False, 6), (True, True, 4), (False, False, 3)])
def test_factory_predict_matches_jax(gas, central, minus_log, order):
    x, u = gas
    xv = np.stack([x, x**2], -1)
    jdata = jx.factory_data_values(uv=u, xv=xv, order=order, central=central)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(xv), order=order, central=central)
    jm = jbeta.factory_extrapmodel(BETA0, jdata, minus_log=minus_log)
    tm = tbeta.factory_extrapmodel(BETA0, tdata, minus_log=minus_log)
    assert_close(tm.predict(BETAS), jm.predict(BETAS), RTOL, ATOL)
    assert_close(tm.derivs(), jm.derivs(), RTOL, ATOL)
    assert_close(tm.predict(1.2, cumsum=True), jm.predict(1.2, cumsum=True), RTOL, ATOL)


def test_xalpha_weighted_predict_matches_jax(gas):
    x, u = gas
    order = 3
    xv = np.stack([x * (1.0 + 0.1 * d) for d in range(order + 1)], 1)  # (R, deriv+1)
    w = np.random.default_rng(2).uniform(0.5, 1.5, u.shape)
    jdata = jx.factory_data_values(uv=u, xv=xv, order=order, central=True, xalpha=True, weight=w)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(xv), order=order, central=True, xalpha=True, weight=tt(w))
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata).predict(BETAS),
        RTOL,
        ATOL,
    )


def test_u_ave_and_observable_validation(gas):
    _, u = gas
    jdata = jx.factory_data_values(uv=u, xv=None, order=4, central=True)
    tdata = tx.factory_data_values(uv=tt(u), xv=None, order=4, central=True)
    assert tdata.x_is_u
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata, name="u_ave").predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata, name="u_ave").predict(BETAS),
        RTOL,
        ATOL,
    )
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata, name="dun_ave", n=2, order=2).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata, name="dun_ave", n=2, order=2).predict(BETAS),
        RTOL,
        ATOL,
    )
    with pytest.raises(ValueError, match="needs moment entries"):
        tbeta.factory_extrapmodel(BETA0, tdata, name="dun_ave", n=3)
    with pytest.raises(ValueError, match="unknown observable"):
        tbeta.factory_derivatives("z_ave", central=True)


def test_resample_same_indices_matches_jax(gas):
    """The README quick start's bootstrap (values path, batched reduction)
    and the count-table bootstrap of DataCentralMomentsVals, fed the same
    numpy indices."""
    x, u = gas
    idx = np.random.default_rng(3).integers(0, u.size, (8, u.size))
    jdata = jx.factory_data_values(uv=u, xv=x, order=5, central=True)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(x), order=5, central=True)
    jm = jbeta.factory_extrapmodel(BETA0, jdata).resample({"indices": idx})
    tm = tbeta.factory_extrapmodel(BETA0, tdata).resample({"indices": tt(idx)})
    assert_close(tm.predict(BETAS), jm.predict(BETAS), RTOL, ATOL)
    jv = jx.DataCentralMomentsVals.from_vals(x, u, 5).resample(idx)
    tv = tx.DataCentralMomentsVals.from_vals(tt(x), tt(u), 5).resample(tt(idx))
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tv).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jv).predict(BETAS),
        RTOL,
        ATOL,
    )
    assert_close((tv.xave, tv.uave, tv.du, tv.dxdu, tv.wsum), (jv.xave, jv.uave, jv.du, jv.dxdu, jv.wsum), RTOL, ATOL)


def test_moment_container_matches_jax(gas):
    x, u = gas
    xb, ub = x.reshape(10, 200), u.reshape(10, 200)
    jd = jx.DataCentralMoments.from_vals(xb, ub, 4)
    td = tx.DataCentralMoments.from_vals(tt(xb), tt(ub), 4)
    fields = lambda d: (d.xave, d.uave, d.du, d.dxdu, d.wsum)  # noqa: E731
    assert_close(fields(td), fields(jd), RTOL, ATOL)
    assert_close(fields(td.reduce()), fields(jd.reduce()), RTOL, ATOL)
    freq = np.random.default_rng(4).integers(0, 3, (6, 10))
    assert_close(fields(td.resample({"freq": tt(freq)})), fields(jd.resample({"freq": freq})), RTOL, ATOL)
    assert_close((td.u, td.xu), (jd.u, jd.xu), RTOL, ATOL)
    assert_close(
        tbeta.factory_extrapmodel(BETA0, td.reduce()).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jd.reduce()).predict(BETAS),
        RTOL,
        ATOL,
    )
    ja = jx.DataCentralMoments.from_ave_central(jd.xave, jd.uave, jd.du, jd.dxdu, wsum=jd.wsum)
    ta = tx.DataCentralMoments.from_ave_central(td.xave, td.uave, td.du, td.dxdu, wsum=td.wsum)
    assert_close(fields(ta), fields(ja), RTOL, ATOL)
    with pytest.raises(ValueError, match="block batch axis"):
        td.reduce().resample({"nrep": 2})


def test_interop_round_trip(gas):
    """A moment state reduced by the JAX package predicts identically in the
    port, and back."""
    x, u = gas
    jd = jx.DataCentralMoments.from_vals(x, u, 6)
    state = interop.data_to_numpy(jd)
    td = interop.data_from_numpy(state, **{k: state[k] for k in interop.FLAGS})
    jpred = jbeta.factory_extrapmodel(BETA0, jd).predict(BETAS)
    assert_close(tbeta.factory_extrapmodel(BETA0, td).predict(BETAS), jpred, 1e-12, ATOL)
    back = interop.data_to_numpy(td)
    jd2 = jx.DataCentralMoments(
        **{k: back[k] for k in interop.FIELDS}, meta=jx.DataCallback(), **{k: back[k] for k in interop.FLAGS}
    )
    assert_close(jbeta.factory_extrapmodel(BETA0, jd2).predict(BETAS), jpred, 1e-12, ATOL)
    with pytest.raises(ValueError, match="missing moment fields"):
        interop.data_from_numpy({"xave": state["xave"]}, order=6)


# -- the serving pipeline -----------------------------------------------------------


@pytest.mark.parametrize("variant", ["flat", "vector", "xalpha", "minus_log", "weighted", "x_is_u"])
def test_pipeline_matches_jax(gas, variant):
    x, u = gas
    order = 5
    kw = {}
    args = [u, x]
    if variant == "vector":
        args = [u, np.stack([x, 2.0 * x + 1.0], 1)]
    elif variant == "xalpha":
        kw["xalpha"] = True
        args = [u, np.stack([x * (1.0 + 0.2 * d) for d in range(order + 1)], 1)]
    elif variant == "minus_log":
        kw["minus_log"] = True
    elif variant == "weighted":
        kw["weighted"] = True
    elif variant == "x_is_u":
        kw["x_is_u"] = True
        args = [u]
    jrun = jpipe.make_extrap_pipeline(order, BETA0, **kw)
    trun = tpipe.make_extrap_pipeline(order, BETA0, **kw)
    jargs = args + [BETAS]
    targs = [tt(a) for a in args] + [tt(BETAS)]
    if variant == "weighted":
        w = np.random.default_rng(6).uniform(0.5, 1.5, u.size)
        jargs.append(w)
        targs.append(tt(w))
    got = trun(*targs)
    assert got.dtype == torch.float64
    assert_close(got, jrun(*jargs), RTOL, ATOL)


def test_pipeline_ci_within_monte_carlo_error():
    """The CPU bootstrap CI (multinomial table from a seeded
    torch.Generator) agrees with the JAX one within Monte-Carlo error, and
    the prediction sits within 5 sigma of the analytic ideal gas."""
    x, u = _ideal_gas(8, 4000)
    nrep = 200
    tpred, tstd = tpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(tt(u), tt(x), tt(BETAS), seed=1)
    jpred, jstd = jpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(u, x, BETAS, seed=1)
    assert_close(tpred, jpred, RTOL, ATOL)
    # the relative spread of a std estimate from nrep replicates is ~1/sqrt(2 nrep) = 5%
    np.testing.assert_allclose(npy(tstd), np.asarray(jstd), rtol=0.25)
    truth = np.array([float(jideal.x_beta_extrap(4, BETA0, b)[0]) for b in BETAS])
    assert np.all(np.abs(npy(tpred) - truth) <= 5 * npy(tstd) + 1e-6)
    tpred2, tstd2 = tpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(tt(u), tt(x), tt(BETAS), seed=1)
    assert torch.equal(tstd, tstd2)  # the seed fixes the replicates
    _, ustd = tpipe.make_extrap_pipeline(3, BETA0, nrep=50, x_is_u=True)(tt(u), tt(BETAS), seed=2)
    assert bool((ustd > 0).all())


def test_pipeline_validation():
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.make_extrap_pipeline(2, BETA0, x_is_u=True, xalpha=True)
    run = tpipe.make_extrap_pipeline(2, BETA0, xalpha=True)
    with pytest.raises(ValueError, match="deriv axis"):
        run(torch.ones(10), torch.ones(10, 2), tt(BETAS))


def test_idealgas_oracle_matches_jax():
    for b in (0.7, 1.0, 1.4):
        assert_close(tideal.x_ave(b), jideal.x_ave(b), 1e-13)
        assert_close(tideal.x_var(b, 2.0), jideal.x_var(b, 2.0), 1e-13)
    # order-6 derivatives cancel to ~1e-3: roundoff of the two exp/series
    # evaluations shows at ~1e-12 absolute
    assert_close(tideal.x_beta_extrap(6, 1.0, 1.3), jideal.x_beta_extrap(6, 1.0, 1.3), 1e-12, 1e-11)
    x, u = tideal.generate_data((5000, 10), 1.0, rng=3)
    assert x.shape == (5000,) and u.shape == (5000,)
    assert abs(float(x.mean()) - float(jideal.x_ave(1.0))) < 5 * float(jideal.x_var(1.0)) ** 0.5 / np.sqrt(50_000)
    assert torch.equal(tideal.x_sample(7, 1.0, rng=4), tideal.x_sample(7, 1.0, rng=4))


def test_port_never_imports_jax():
    """``import thermoextrap_tpu_torch`` (with the CUDA wrappers) pulls in
    neither jax nor the JAX package."""
    code = (
        "import sys; before = set(sys.modules); "
        "import thermoextrap_tpu_torch, thermoextrap_tpu_torch.ops.moments_cuda; "
        "new = set(sys.modules) - before; "
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'thermoextrap_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""tests/test_xalpha_statistical.py :34, :44 and :52 on the torch port: the
β-dependent observable ``beta * x`` with explicit derivative data, raw and
central, against the analytic ideal gas within 5 bootstrap σ, and against
the JAX package on the same samples: 1e-10 central, 1e-6 raw (the raw
order-4 moments of u, about 15 σ from 0, cancel ~5 digits when they are
recentred, and the two packages sum in another order).  The GPR
cases (:66, :85) wait for the GPR port."""

import numpy as np
import pytest
from _torch_parity import npy

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jb
from thermoextrap_tpu_torch import beta as beta_xpan
from thermoextrap_tpu_torch import idealgas

BETA0 = 5.6
ORDER = 4
NSAMP, NPART = 50_000, 200
RTOL = {False: 1e-6, True: 1e-10}


@pytest.fixture(scope="module")
def samples():
    """``(u, deriv_vals)`` of the ideal gas at β0, drawn by numpy: the
    observable ``beta * x`` has ``x^(0) = beta0 x``, ``x^(1) = x``."""
    rng = np.random.default_rng(9)
    pos = -np.log1p(-rng.random((NSAMP, NPART)) * (1.0 - np.exp(-BETA0))) / BETA0
    x, u = pos.mean(-1), pos.sum(-1)
    deriv_vals = np.zeros((NSAMP, ORDER + 1, 1))
    deriv_vals[:, 0, 0] = BETA0 * x
    deriv_vals[:, 1, 0] = x
    return u, deriv_vals


@pytest.fixture(scope="module", params=[False, True], ids=["raw", "central"])
def models(request, samples):
    u, deriv_vals = samples
    kws = {"uv": u, "xv": deriv_vals, "order": ORDER, "central": request.param, "xalpha": True}
    port = beta_xpan.factory_extrapmodel(BETA0, tx.factory_data_values(**kws))
    ref = jb.factory_extrapmodel(BETA0, jx.factory_data_values(**kws))
    return port, ref, RTOL[request.param]


def _boot(model):
    return model.resample({"nrep": 80, "rng": 3})


def test_derivs_match_analytic(models):
    model, ref, rtol = models
    derivs = npy(model.derivs())[:, 0]
    std = npy(_boot(model).derivs())[:, :, 0].std(axis=1)
    exact = np.array([float(idealgas.dbeta_xave_depend(k)(BETA0, 1.0)) for k in range(ORDER + 1)])
    assert np.all(np.abs(derivs - exact) < 5 * std + 1e-10)
    np.testing.assert_allclose(derivs, np.asarray(ref.derivs())[:, 0], rtol=rtol, atol=1e-12)


def test_extrapolation_matches_analytic(models):
    model, ref, rtol = models
    b = BETA0 + 0.3
    pred = float(npy(model.predict(b))[0])
    exact = float(idealgas.x_beta_extrap_depend(ORDER, BETA0, b, 1.0)[0])
    std = float(npy(_boot(model).predict(b)).std())
    assert abs(pred - exact) < 5 * std + 1e-10
    np.testing.assert_allclose(pred, float(np.asarray(ref.predict(b))[0]), rtol=rtol)


def test_minus_log_xalpha(models):
    model, ref, rtol = models
    b = BETA0 - 0.3
    pred = float(npy(model.predict(b, minus_log=True))[0])
    exact = float(idealgas.x_beta_extrap_depend_minuslog(ORDER, BETA0, b, 1.0)[0])
    std = float(npy(_boot(model).predict(b, minus_log=True)).std())
    assert abs(pred - exact) < 5 * std + 1e-9
    np.testing.assert_allclose(pred, float(np.asarray(ref.predict(b, minus_log=True))[0]), rtol=rtol)

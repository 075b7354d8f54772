"""The GP staging and builders of the torch port (``gpr_active.active_utils``,
``gpr_active.ig_active``, ``stack.GPRData.to_gpr_data`` and
``pipeline.make_gpr_pipeline``) against the JAX package; the port's mirror of
the GPR tests of tests/test_active.py (:37, :47, :57, :75), test_stack.py
(:34, :50 and :92's GP half), test_xalpha_statistical.py (:66, :85) and
test_native.py (:75); the GPR path without sympy; and import parity.

Parity: both packages' bootstrap streams differ, so each state is built in
both from one numpy source of samples, and its bootstrap reads one numpy
index table (the ``{"nrep": n}`` resample of the staging is pointed at it).
Staged inputs agree to 1e-10 (the derivatives) and 1e-8 of the largest
entry (the covariances).  The builders take the same ``(X, Y, cov)``; their
trained NLL agrees to 1e-6 relative and their posterior means to 1e-3 of
the posterior sigma, as in tests/test_torch_gpr.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import sympy as sp
import torch
from _torch_parity import npy
from torch.profiler import profile

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu.gpr_active import active_utils as jau
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import gpr_active
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch import stack
from thermoextrap_tpu_torch.gpr_active import active_utils as au
from thermoextrap_tpu_torch.gpr_active import gp_models, ig_active, kernels
from thermoextrap_tpu_torch.utils import compute, trace

NCONF, NPART = 2_000, 200


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(beta, seed, nrep=30, two_outputs=False, order=3):
    """One ideal-gas state in both packages ``(port, JAX)`` from numpy
    samples; each bootstrap reads one numpy index table."""
    rng = np.random.default_rng(seed)
    pos = -np.log1p(-rng.random((NCONF, NPART)) * (1.0 - np.exp(-beta))) / beta
    xv = np.stack([pos.mean(-1), (pos**2).mean(-1)], axis=1) if two_outputs else pos.mean(-1)[:, None]
    u = pos.sum(-1)
    idx = rng.integers(0, NCONF, (nrep, NCONF))
    out = []
    for pkg, fac in ((tx, tbeta), (jx, jbeta)):
        state = fac.factory_extrapmodel(beta, pkg.DataCentralMomentsVals.from_vals(xv, u, order))
        real = state.resample
        state.resample = lambda sampler, real=real: real({"indices": idx})
        out.append(state)
    return out


def _assert_staged(got, ref):
    (x, y, cov), (jx_, jy, jcov) = got, ref
    for a in (x, y, cov):
        assert isinstance(a, np.ndarray) and a.dtype == np.float64
    np.testing.assert_array_equal(x, np.asarray(jx_))
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-10)
    jcov = np.asarray(jcov)
    assert cov.shape == jcov.shape
    assert np.max(np.abs(cov - jcov)) <= 1e-8 * np.max(np.abs(jcov))


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("two_outputs", [False, True])
def test_input_GP_from_state_matches_jax(log_scale, two_outputs):
    t, j = _states(1.3, 7, two_outputs=two_outputs)
    _assert_staged(au.input_GP_from_state(t, n_rep=30, log_scale=log_scale), jau.input_GP_from_state(j, n_rep=30, log_scale=log_scale))


def test_input_GP_from_state_replicate_axis_matches_jax():
    """A state whose data already carries the replicate axis (the moments
    of ``resample({"indices": ...})``) is staged from it, in both packages."""
    t, j = _states(0.9, 3)
    idx = np.random.default_rng(11).integers(0, NCONF, (25, NCONF))
    t = tbeta.factory_extrapmodel(0.9, t.data.resample({"indices": idx}))
    j = jbeta.factory_extrapmodel(0.9, j.data.resample({"indices": idx}))
    _assert_staged(au.input_GP_from_state(t), jau.input_GP_from_state(j))


@pytest.fixture(scope="module")
def staged():
    """JAX-staged ``(x, y, cov)`` of three states: the builders' common input."""
    return [jau.input_GP_from_state(_states(b, 20 + i)[1]) for i, b in enumerate((0.8, 1.4, 2.0))]


def _close_posteriors(gpr, jgpr, locs, orders=(0, 1)):
    for order in orders:
        xt = np.column_stack([locs, np.full_like(locs, order)])
        mean, var = (npy(a) for a in gpr.predict_f(xt))
        jmean, jvar = (np.asarray(a) for a in jgpr.predict_f(xt))
        assert mean.shape == jmean.shape
        assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))


def test_create_GPR_matches_jax(staged):
    gpr = au.create_GPR([lambda d=d: d for d in staged])
    jgpr = jau.create_GPR([lambda d=d: d for d in staged])
    assert isinstance(gpr.mean_function, gp_models.LinearWithDerivs)
    np.testing.assert_allclose(npy(gpr.scale_fac), np.asarray(jgpr.scale_fac), rtol=1e-12)
    nll = float(gpr.neg_lml(gpr.get_unconstrained()))
    assert nll == pytest.approx(float(jgpr.neg_lml(np.asarray(jgpr.get_unconstrained()))), rel=1e-6)
    _close_posteriors(gpr, jgpr, np.linspace(0.8, 2.0, 9))


def test_make_gpr_pipeline_matches_jax(staged):
    states = [lambda d=d: d for d in staged]
    gpr, predict = tpipe.make_gpr_pipeline(states, orders=(0, 1))
    jgpr, jpredict = jpipe.make_gpr_pipeline(states, orders=(0, 1))
    alphas = np.linspace(0.8, 2.0, 11)
    for order in (0, 1):
        mean, var = predict(alphas, order=order)
        jmean, jvar = jpredict(alphas, order=order)
        assert isinstance(mean, np.ndarray) and mean.dtype == np.float64 and mean.shape == (11, 1) == var.shape
        assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))
    with pytest.raises(ValueError, match="order"):
        predict(alphas, order=2)
    empty = predict([])
    assert empty[0].shape == (0, 1) == empty[1].shape
    with pytest.raises(ValueError, match="bucket"):
        tpipe.make_gpr_pipeline(states, bucket=0)


def test_make_gpr_pipeline_log_scale_matches_jax():
    pairs = [_states(b, 30 + i) for i, b in enumerate((0.8, 1.6))]
    _, predict = tpipe.make_gpr_pipeline([p[0] for p in pairs], log_scale=True)
    _, jpredict = jpipe.make_gpr_pipeline([p[1] for p in pairs], log_scale=True)
    mean, _ = predict(np.linspace(0.8, 1.6, 5))
    jmean, jvar = jpredict(np.linspace(0.8, 1.6, 5))
    assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))


def _write_sim_files(tmp_path, rng):
    n = 400
    u = rng.normal(5.0, 1.0, n)
    cv = rng.normal(1.0, 0.2, n)
    np.savetxt(tmp_path / "sim_info.txt", np.stack([np.arange(n), np.zeros(n), u], axis=1))
    np.savetxt(tmp_path / "cv_bias.txt", np.stack([np.arange(n), cv, 0.1 * cv], axis=1))
    return [str(tmp_path / "sim_info.txt")], [str(tmp_path / "cv_bias.txt")], n


def test_datawrapper_matches_jax(tmp_path, rng_np):
    """The file pipeline (C++ loader, statistical inefficiency, unbiasing)
    gives the JAX package's samples, and a state of the same derivatives."""
    info, bias, n = _write_sim_files(tmp_path, rng_np)
    dw = au.DataWrapper(info, bias, beta=1.2, n_frames=n)
    jdw = jau.DataWrapper(info, bias, beta=1.2, n_frames=n)
    got, ref = dw.get_data(), jdw.get_data()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-12)
    np.testing.assert_allclose(npy(dw.build_state(got, 2).derivs()), np.asarray(jdw.build_state(ref, 2).derivs()), rtol=1e-10)


def test_ig_harness():
    """``IG_DataWrapper`` splits its generator at each request (fresh data,
    same seed -> same data); ``SimulateIG`` seeds wrappers by a counter."""
    a, b = ig_active.IG_DataWrapper(1.3, rng=5, nconfig=300, npart=20), ig_active.IG_DataWrapper(1.3, rng=5, nconfig=300, npart=20)
    u1, x1, w1 = a.get_data()
    assert u1.shape == (300,) and x1.shape == (300, 1) and torch.equal(w1, torch.ones(300, dtype=u1.dtype))
    assert torch.equal(u1, b.get_data()[0])
    assert not torch.equal(u1, a.get_data()[0])
    assert a.build_state(max_order=2).order == 2
    sim = ig_active.SimulateIG(nconfig=100, npart=10)
    wrappers = [sim.run_sim(None, 1.1), sim.run_sim(None, 1.1)]
    assert not torch.equal(wrappers[0].get_data()[0], wrappers[1].get_data()[0])
    state = ig_active.multiOutput_extrap_IG(1.1, rng=2, nconfig=200, npart=30)
    assert tuple(state.derivs().shape) == (4, 2)


def test_gprdata_staging():
    """tests/test_stack.py:34, both halves: the stacked arrays and the full
    block-diagonal GP input of ``to_gpr_data``."""
    states = [ig_active.extrap_IG(b, rng=i, nconfig=1000, npart=200) for i, b in enumerate([0.8, 1.6])]
    gd = stack.GPRData(states, nrep=20)
    x, _ys = gd.array_data()
    assert x.shape == (8, 2)
    X, Y, cov = gd.to_gpr_data()
    assert X.shape == (8, 2)
    assert Y.shape == (8, 1)
    assert cov.shape == (1, 8, 8)
    np.testing.assert_allclose(cov[0][:4, 4:], 0.0)


def test_gprdata_to_gpr_data_matches_jax():
    pairs = [_states(b, 40 + i) for i, b in enumerate((0.8, 1.6))]
    got = stack.GPRData([p[0] for p in pairs], nrep=30).to_gpr_data(log_scale=True)
    from thermoextrap_tpu import stack as jstack

    _assert_staged(got, jstack.GPRData([p[1] for p in pairs], nrep=30).to_gpr_data(log_scale=True))


def test_states_derivs_concat():
    states = [ig_active.extrap_IG(b, rng=i, nconfig=500, npart=100) for i, b in enumerate([0.9, 1.4])]
    assert stack.states_derivs_concat(states).shape == (8, 1)


def test_multidim_observable_gpr_staging():
    """The GP half of tests/test_stack.py:92: a (rec, 2, 3) observable fits
    as a 6-output GP."""

    def mk(b, seed):
        rng = np.random.default_rng(seed)
        u = rng.normal(2.0, 1.0, 600)
        x = np.stack([0.1 * k + 0.3 * u + rng.normal(size=600) for k in range(6)], axis=1).reshape(600, 2, 3)
        return tbeta.factory_extrapmodel(b, tx.factory_data_values(uv=u, xv=x, order=2, central=True))

    gpr = au.create_GPR([mk(0.8, 0), mk(1.6, 1)])
    assert gpr.Y.shape == (6, 6)
    mu, _var = gpr.predict_f(np.array([[1.2, 0.0]]))
    assert npy(mu).shape == (1, 6)
    assert np.all(np.isfinite(npy(mu)))


def test_gpr_multioutput_input():
    state = ig_active.multiOutput_extrap_IG(1.1, rng=2, nconfig=2000, npart=300)
    _x, y, cov = au.input_GP_from_state(state, n_rep=25)
    assert y.shape == (4, 2)
    assert cov.shape == (2, 4, 4)
    gpr = au.create_GPR([state, ig_active.multiOutput_extrap_IG(1.8, rng=3, nconfig=2000, npart=300)])
    mu, var = gpr.predict_f(np.array([[1.4, 0.0]]))
    assert npy(mu).shape == (1, 2)
    assert np.all(npy(var) > 0)


def test_gpr_param_checkpoint(tmp_path):
    gpr = au.create_GPR([ig_active.extrap_IG(b, rng=i, nconfig=1000, npart=200) for i, b in enumerate([0.9, 1.7])])
    path = tmp_path / "params.json"
    gpr.save_params(path)
    before = gpr.parameters()
    gpr.set_parameters({k: v * 2 for k, v in before.items()})
    gpr.load_params(path)
    for k, v in gpr.parameters().items():
        np.testing.assert_allclose(v, before[k], rtol=1e-12)


class TestInputAssembly:
    def test_input_GP_from_state(self):
        state = ig_active.extrap_IG(1.5, rng=3, nconfig=NCONF, npart=NPART)
        x, y, cov = au.input_GP_from_state(state, n_rep=30)
        assert x.shape == (4, 2)
        assert y.shape == (4, 1)
        assert cov.shape == (1, 4, 4)
        np.testing.assert_array_equal(x[:, 1], np.arange(4))
        assert np.all(np.diag(cov[0]) > 0)

    def test_log_scale(self):
        state = ig_active.extrap_IG(2.0, rng=4, nconfig=NCONF, npart=NPART)
        x, y, _cov = au.input_GP_from_state(state, n_rep=20, log_scale=True)
        np.testing.assert_allclose(x[:, 0], np.log10(2.0))
        _x2, y2, _ = au.input_GP_from_state(state, n_rep=20)
        np.testing.assert_allclose(y[1, 0], y2[1, 0] * 2.0 * np.log(10.0), rtol=1e-7)

    def test_log_scale_bell_closed_form(self):
        ln10 = np.log(10.0)
        for a in (0.7, 2.3):
            for n in range(1, 8):
                for k in range(1, n + 1):
                    ref = float(sp.bell(n, k, [a * ln10**j for j in range(1, n - k + 2)]))
                    np.testing.assert_allclose(a**k * ln10**n * au._stirling2(n, k), ref, rtol=1e-12)

    def test_get_logweights(self):
        w = np.exp(au.get_logweights(np.array([0.0, 1.0, 2.0])))
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-12)
        assert w[2] > w[0]


def test_datawrapper_uses_fastloader(tmp_path, rng_np):
    """tests/test_native.py:75."""
    n = 400
    u = rng_np.normal(5.0, 1.0, n)
    cv = rng_np.normal(1.0, 0.2, n)
    np.savetxt(tmp_path / "sim_info.txt", np.stack([np.arange(n), np.zeros(n), u], axis=1))
    np.savetxt(tmp_path / "cv_bias.txt", np.stack([np.arange(n), cv, np.zeros(n)], axis=1))
    dw = au.DataWrapper([str(tmp_path / "sim_info.txt")], [str(tmp_path / "cv_bias.txt")], beta=1.0, n_frames=n, cv_cols=[1, 2])
    pot, x, w = dw.get_data()
    assert pot.shape[0] == x.shape[0] == w.shape[0]
    state = dw.build_state(max_order=2)
    assert state.order == 2
    assert np.isfinite(npy(state.derivs())).all()


# -- the bootstrap tables' stream, the spans and the evaluation counter ---------------------


def _ig_states(betas=(0.8, 1.6), nconfig=1000, npart=100):
    return [ig_active.extrap_IG(b, rng=i, nconfig=nconfig, npart=npart) for i, b in enumerate(betas)]


def _staged_by_create_GPR(monkeypatch, states, **kws):
    """``create_GPR``'s stacked ``(x, y, noise_cov)``, its fit left out."""
    seen = []
    real = au.create_base_GP_model
    monkeypatch.setattr(au, "create_base_GP_model", lambda data, **k: seen.append(data) or real(data, **k))
    monkeypatch.setattr(au, "train_GPR", lambda *a, **k: None)
    au.create_GPR(states, **kws)
    return seen[0]


def test_input_GP_from_state_rng_draws_the_table():
    """An equal seed or an equally seeded generator gives equal inputs, and
    another seed another table; None gives the default seed's table, the
    staging's numbers before ``rng`` existed."""
    (state,) = _ig_states((1.3,))
    x, y, cov = au.input_GP_from_state(state, n_rep=20, rng=5)
    _, y5, cov5 = au.input_GP_from_state(state, n_rep=20, rng=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(cov, cov5)
    np.testing.assert_array_equal(y, y5)
    _, y6, cov6 = au.input_GP_from_state(state, n_rep=20, rng=6)
    np.testing.assert_array_equal(y, y6)  # the derivatives do not resample
    assert not np.allclose(cov, cov6)
    _, _, cov_none = au.input_GP_from_state(state, n_rep=20)
    old = npy(state.resample({"nrep": 20}).derivs())[:, :, 0]
    np.testing.assert_array_equal(cov_none[0], np.cov(old))


def test_create_GPR_draws_each_states_table_in_turn(monkeypatch):
    """``rng`` is one stream: state ``k``'s table is its ``k``-th draw, so
    the states' tables differ; with None every state draws the default
    seed's table."""
    states = _ig_states((0.8, 0.8))  # two states of one sampling seed...
    states[1] = tbeta.factory_extrapmodel(0.8, states[0].data)  # ...and the same samples
    _, _, cov = _staged_by_create_GPR(monkeypatch, states, rng=11)
    assert not np.allclose(cov[0, :4, :4], cov[0, 4:, 4:])
    gen = torch.Generator().manual_seed(11)
    for k in range(2):
        np.testing.assert_array_equal(cov[0, 4 * k : 4 * k + 4, 4 * k : 4 * k + 4], au.input_GP_from_state(states[k], rng=gen)[2][0])
    _, _, same = _staged_by_create_GPR(monkeypatch, states, rng=11)
    np.testing.assert_array_equal(cov, same)
    _, _, cov_none = _staged_by_create_GPR(monkeypatch, states)
    np.testing.assert_array_equal(cov_none[0, :4, :4], cov_none[0, 4:, 4:])


def test_make_gpr_pipeline_forwards_rng():
    states = _ig_states()
    alphas = np.linspace(0.8, 1.6, 5)
    a = tpipe.make_gpr_pipeline(states, rng=3)[1](alphas)
    b = tpipe.make_gpr_pipeline(states, rng=torch.Generator().manual_seed(3))[1](alphas)
    c = tpipe.make_gpr_pipeline(states, rng=4)[1](alphas)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert not np.allclose(a[1], c[1])


def test_make_gpr_pipeline_spans_and_counter():
    """Under a profiler, training is the call ``te.gpr.train`` with the
    stages ``te.gpr.inputs`` and ``te.gpr.fit``, and a prediction the call
    ``te.gpr.predict``; ``gpr_lml_evals`` counts the fit's evaluations, its
    ``nfev`` and the start and final ones."""
    assert trace.COUNTERS["gpr_lml_evals"] is gp_models.GPR_LML_EVALS
    states = _ig_states()
    with profile() as prof:
        _gpr, predict = tpipe.make_gpr_pipeline(states, rng=3)
        predict(np.linspace(0.8, 1.6, 5))
    train, pred = trace.calls()[-2:]
    assert (train["name"], pred["name"]) == ("te.gpr.train", "te.gpr.predict")
    stages = [s[2] for s in train["spans"] if s[1] == "te.gpr.train"]
    assert stages.count("te.gpr.inputs") == 1 and stages.count("te.gpr.fit") == 1
    assert train["counters"]["gpr_lml_evals"]["n"] >= 3 and pred["counters"]["gpr_lml_evals"]["n"] == 0
    names = {e.name for e in prof.events()}
    assert {"te.gpr.train", "te.gpr.inputs", "te.gpr.fit", "te.gpr.predict"} <= names

    gpr = au.create_GPR(states, rng=3)
    gpr.set_parameters({"kernel/l": 1.0, "kernel/var": 1.0, "likelihood/p": 10.0})
    before = gp_models.GPR_LML_EVALS["n"]
    res = gpr.train()
    assert res.nfev >= 2 and gp_models.GPR_LML_EVALS["n"] - before == res.nfev + 2


def test_constant_partials_fill_the_kernel_matrix():
    """A sympy kernel whose partials include plain numbers (``var x1 x2 +
    1``: those of order 2 are 0) gives the closed form's matrix and
    diagonal, each number filled in the locations' dtype (on their device,
    so that a fit on the card can be captured)."""
    x1, x2, var = sp.symbols("x1 x2 var", real=True)
    kern = gp_models.DerivativeKernel(var * x1 * x2 + 1, 1, kernel_params={"var": 2.0})
    locs = np.array([0.3, -1.2, 2.0])
    X = np.vstack([np.column_stack([locs, np.full(3, d)]) for d in (0, 1, 2)])
    a, d = X[:, 0], X[:, 1]
    da, db = d[:, None], d[None, :]
    want = np.select(
        [(da == 0) & (db == 0), (da == 1) & (db == 0), (da == 0) & (db == 1), (da == 1) & (db == 1)],
        [2.0 * a[:, None] * a[None, :] + 1.0, np.broadcast_to(2.0 * a[None, :], (9, 9)), np.broadcast_to(2.0 * a[:, None], (9, 9)), np.full((9, 9), 2.0)],
        default=0.0,
    )
    got, diag = kern.K(X), kern.K_diag(X)
    assert got.dtype == diag.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(diag.numpy(), np.diag(want))


# -- the GPR path without sympy, import parity, the compute device --------------------------


def test_gpr_runs_without_sympy():
    """With sympy blocked: the package and ``gpr_active`` import (lazily),
    ``create_GPR`` with the default kernel, ``make_gpr_pipeline`` and
    ``predict_f_batched`` run, and a sympy-expression constructor raises the
    ``ImportError`` that names the kernels that are not sympy expressions.
    (The callable kernels' ``torch.func.grad`` loads ``torch._dynamo``,
    which imports sympy, torch's own dependency.)"""
    code = """
import sys
sys.modules["sympy"] = None
import numpy as np, torch
torch.set_num_threads(1)
import thermoextrap_tpu_torch as tx
tx.set_default_device("cpu")
assert "thermoextrap_tpu_torch.gpr_active" not in sys.modules
from thermoextrap_tpu_torch.gpr_active import active_utils, ig_active, kernels, gp_models
from thermoextrap_tpu_torch.pipeline import make_gpr_pipeline
states = [ig_active.extrap_IG(b, rng=i, nconfig=1000, npart=100) for i, b in enumerate((1.0, 2.0))]
gpr = active_utils.create_GPR(states)
mean, var = gpr.predict_f(np.array([[1.5, 0.0]]))
assert np.isfinite(mean.numpy()).all() and (var.numpy() > 0).all()
_, predict = make_gpr_pipeline(states, orders=(0, 1))
m, v = predict(np.linspace(1.0, 2.0, 5), order=1)
assert m.shape == (5, 1) and np.isfinite(m).all()
mb, vb = gp_models.predict_f_batched([gpr, gpr], np.array([[1.5, 0.0], [1.2, 1.0]]))
assert torch.equal(mb[0], mb[1]) and mb.shape == (2, 2, 1)
for make in (kernels.make_rbf_expr, lambda: gp_models.DerivativeKernel(None)):
    try:
        make()
    except ImportError as err:
        assert "RBFDerivKernel" in str(err) and "CallableDerivativeKernel" in str(err), err
    else:
        raise AssertionError("a sympy constructor ran without sympy")
# the default active loop (ALM), the frozen predictor and the noise GPs need no sympy either
from thermoextrap_tpu_torch.gpr_active import experimental, serving, sine_active
sim = ig_active.SimulateIG(nconfig=400, npart=50)
data_list, hist = active_utils.active_learning(
    [0.8, 2.0], sim, active_utils.UpdateALMbrute(n_grid=40), stop_criteria=active_utils.StopCriteria([active_utils.MaxVar(1e-12)], n_grid=40),
    max_iter=1, max_order=2,
)
assert len(data_list) >= 2 and len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
fm, fv = serving.freeze_predictor(gpr)(np.array([1.5]))
assert np.isfinite(fm.numpy()).all() and (fv.numpy() >= 0).all()
X, Y, Yerr = sine_active.make_data(np.linspace(0.0, 3.0, 6), max_order=0, rng=1)
het = experimental.FullyHeteroscedasticGPR((X[:, :1], np.hstack([Y, Yerr, np.full_like(Y, 50.0)])), experimental.StationaryKernel(1, "rbf"))
assert np.isfinite(float(het.log_marginal_likelihood()))
assert "sympy" not in sys.modules or sys.modules["sympy"] is None
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "thermoextrap_tpu") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr


def test_all_names_but_the_active_learning_half():
    """Every public name of the JAX package's ``gpr_active`` and of its
    modules (the active-learning half of ``active_utils``, ``experimental``,
    ``serving`` and ``sine_active`` among them) is in the port; nothing is
    left to reject."""
    from thermoextrap_tpu import gpr_active as jgpr
    from thermoextrap_tpu.gpr_active import experimental as jexp
    from thermoextrap_tpu.gpr_active import gp_models as jgm
    from thermoextrap_tpu.gpr_active import ig_active as jig
    from thermoextrap_tpu.gpr_active import kernels as jkern
    from thermoextrap_tpu.gpr_active import serving as jserving
    from thermoextrap_tpu.gpr_active import sine_active as jsine
    from thermoextrap_tpu_torch.gpr_active import experimental, serving, sine_active

    pairs = ((gpr_active, jgpr), (au, jau), (gp_models, jgm), (kernels, jkern), (ig_active, jig))
    for mod, jmod in (*pairs, (experimental, jexp), (serving, jserving), (sine_active, jsine)):
        assert set(mod.__all__) == set(jmod.__all__), mod.__name__
        for name in mod.__all__:
            assert getattr(mod, name) is not None
        assert not hasattr(mod, "_NOT_PORTED")
        with pytest.raises(AttributeError):
            mod.no_such_name  # noqa: B018
    assert gp_models.FullyHeteroscedasticGPR is experimental.FullyHeteroscedasticGPR
    assert tx.gpr_active is gpr_active


def test_compute_device(monkeypatch):
    """The GPR core runs on the default device, and on the CPU inside
    ``host_f64``: nothing else moves it."""
    from thermoextrap_tpu_torch.utils import device as tdevice

    monkeypatch.setattr(tdevice, "_DEVICE", torch.device("meta"))
    assert compute.compute_device().type == "meta"
    with compute.host_f64():
        assert compute.compute_device() == torch.device("cpu")
        with compute.host_f64():
            pass
        assert compute.compute_device() == torch.device("cpu")
        X = np.array([[0.1, 0.0], [0.4, 1.0]])
        k = kernels.RBFDerivKernel().K(X)
        assert k.device.type == "cpu" and k.dtype == torch.float64
    assert compute.compute_device().type == "meta"
    assert kernels.RBFDerivKernel().K(X).device.type == "meta"

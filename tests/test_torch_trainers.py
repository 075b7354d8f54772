"""The adaptive and recursive trainers and the GPR data staging of the torch
port (``adaptive_interp``, ``recursive_interp``, ``stack``) against the JAX
package, and the port's mirror of tests/test_adaptive.py and
tests/test_stack.py.

Parity: one numpy source draws each state's ideal-gas samples and its
bootstrap index table from the seed and the bits of ``float32(beta)``, and
both packages build the same state from them, so neither package's
bootstrap stream plays a part.  The trainers must then choose the same
states in the same order, with ``info`` equal to rtol 1e-10, and the final
models must predict the same to 1e-10.  The states are order 1 and at most
four a model: the JAX package's joint polynomial in powers of absolute β
loses digits as the states grow (ROADMAP Queue 3's caveats).
"""

import numpy as np
import pytest
import torch
from _torch_parity import npy

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import adaptive_interp as ja
from thermoextrap_tpu import beta as jb
from thermoextrap_tpu import stack as jstack
from thermoextrap_tpu.models.extrap import InterpModel as JInterp
from thermoextrap_tpu.models.extrap import InterpModelPiecewise as JPiecewise
from thermoextrap_tpu.recursive_interp import RecursiveInterp as JRecursive
from thermoextrap_tpu_torch import adaptive_interp, idealgas, stack
from thermoextrap_tpu_torch import beta as beta_xpan
from thermoextrap_tpu_torch.models.extrap import InterpModel, InterpModelPiecewise
from thermoextrap_tpu_torch.recursive_interp import RecursiveInterp
from thermoextrap_tpu_torch.utils.random import split

RTOL = 1e-10
ALPHAS = np.linspace(0.5, 2.0, 21)
TRAIN = {"maxiter": 4, "tol": 0.002}


def _draw(beta, nconfig=2_000, npart=50, nrep=20, seed=3):
    """Ideal-gas ``(x, u)`` per configuration and a bootstrap index table,
    drawn by numpy from ``seed`` and the bits of ``float32(beta)``."""
    rng = np.random.default_rng([seed, int(np.float32(beta).view(np.uint32))])
    pos = -np.log1p(-rng.random((nconfig, npart)) * (1.0 - np.exp(-beta))) / beta
    return pos.mean(-1), pos.sum(-1), rng.integers(0, nconfig, (nrep, nconfig))


def _state(pkg, beta, order=1):
    x, u, idx = _draw(beta)
    data = pkg.DataCentralMomentsVals.from_vals(x, u, order).resample({"indices": idx})
    return (jb if pkg is jx else beta_xpan).factory_extrapmodel(beta, data)


def _assert_info(got, ref):
    assert [i["depth"] for i in got] == [i["depth"] for i in ref]
    assert [i.get("alpha_new") for i in got] == [i.get("alpha_new") for i in ref]
    for g, r in zip(got, ref):
        assert list(g["alpha0"]) == list(r["alpha0"])
        assert isinstance(g["err"], np.ndarray)
        np.testing.assert_allclose(g["err"], np.asarray(r["err"]), rtol=RTOL)
        np.testing.assert_allclose(g["ave"], np.asarray(r["ave"]), rtol=RTOL)
        if "err_max" in r:
            np.testing.assert_allclose(g["err_max"], r["err_max"], rtol=RTOL)


@pytest.fixture(scope="module")
def iterative():
    run = {
        pkg: (ja if pkg is jx else adaptive_interp).train_iterative(
            ALPHAS, lambda b, pkg=pkg: _state(pkg, b), JInterp if pkg is jx else InterpModel, maxiter=3, tol=5e-4
        )
        for pkg in (jx, tx)
    }
    return run[tx], run[jx]


@pytest.fixture(scope="module")
def recursive():
    run = {
        pkg: (ja if pkg is jx else adaptive_interp).train_recursive(
            ALPHAS, lambda b, pkg=pkg: _state(pkg, b), JInterp if pkg is jx else InterpModel, **TRAIN
        )
        for pkg in (jx, tx)
    }
    return run[tx], run[jx]


def test_train_iterative_matches_jax(iterative):
    (model, info), (jmodel, jinfo) = iterative
    assert [i.get("alpha_new") for i in info] == [0.95, 1.55, 1.7]
    _assert_info(info, jinfo)
    assert model.alpha0 == list(jmodel.alpha0) == [0.5, 0.95, 1.55, 2.0]
    np.testing.assert_allclose(npy(model.predict(ALPHAS)), np.asarray(jmodel.predict(ALPHAS)), rtol=RTOL)


def test_train_recursive_matches_jax(recursive):
    """The same states in the same order, duplicates included (the JAX
    package's trainer can pick an interval's own edge: ROADMAP Queue 3)."""
    (states, info), (jstates, jinfo) = recursive
    alpha0 = [s.alpha0 for s in states]
    assert alpha0 == [s.alpha0 for s in jstates]
    assert len(set(alpha0)) > 2
    _assert_info(info, jinfo)
    unique = {s.alpha0: s for s in states}
    junique = {s.alpha0: s for s in jstates}
    got = InterpModelPiecewise([unique[a] for a in sorted(unique)]).predict(ALPHAS)
    ref = JPiecewise([junique[a] for a in sorted(junique)]).predict(ALPHAS)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=RTOL)


def _replicate_sampler(base):
    """``base`` (an InterpModel class) whose ``{"nrep": n}`` resample takes
    each state's index table from :func:`_draw`'s numpy source."""

    class Model(base):
        def resample(self, sampler, **kws):
            tables = [{"indices": _draw(s.alpha0, nrep=sampler["nrep"], seed=9)[2]} for s in self.states]
            return base.resample(self, tables, **kws)

    return Model


def _get_data(pkg):
    def get_data(beta):
        x, u, _ = _draw(beta, seed=7)
        return pkg.factory_data_values(uv=u, xv=x, order=1)

    return get_data


def test_recursive_interp_matches_jax():
    """``RecursiveInterp`` with ``get_data`` and the bootstrap tables of one
    numpy source: the same edges and the same predictions."""
    derivs = {pkg: (jb if pkg is jx else beta_xpan).factory_derivatives("x_ave", central=False) for pkg in (jx, tx)}
    runs = {}
    for pkg, cls, model in ((jx, JRecursive, JInterp), (tx, RecursiveInterp, InterpModel)):
        ri = cls(_replicate_sampler(model), derivs[pkg], edge_beta=[0.5, 2.0], max_order=1, tol=0.0027, nrep=20)
        ri.get_data = _get_data(pkg)
        ri.recursive_train(0.5, 2.0, recurse_max=4)
        runs[pkg] = ri
    assert len(runs[tx].edge_beta) > 2
    np.testing.assert_array_equal(runs[tx].edge_beta, runs[jx].edge_beta)
    betas = np.linspace(0.55, 1.95, 9)
    np.testing.assert_allclose(runs[tx].predict(betas), np.asarray(runs[jx].predict(betas)), rtol=RTOL)


# -- tests/test_adaptive.py on the port ----------------------------------------------


ORDER = 2


def small_state(beta, rng=None, nrep=40):
    return adaptive_interp.factory_state_idealgas(beta, ORDER, nrep=nrep, nconfig=2_000, npart=500, rng=rng)


class TestTrainIterative:
    def test_converges_and_predicts(self):
        model, info = adaptive_interp.train_iterative(
            np.linspace(0.5, 2.0, 31),
            factory_state=small_state,
            factory_statecollection=InterpModel,
            maxiter=5,
            tol=0.01,
            state_kws={"rng": 7},
        )
        assert model is not None
        assert 1 <= len(info) <= 5
        pred = npy(model.predict(1.2)).mean()
        assert abs(pred - float(idealgas.x_ave(1.2))) < 0.02

    def test_callback_stops(self):
        calls = []

        def cb(model, alphas, info, **kws):
            calls.append(info["depth"])
            return True

        _model, info = adaptive_interp.train_iterative(
            np.linspace(0.5, 2.0, 11),
            factory_state=small_state,
            factory_statecollection=InterpModel,
            maxiter=5,
            callback=cb,
            state_kws={"rng": 3},
        )
        assert len(info) == 1
        assert calls == [0]

    def test_maxiter_must_be_positive(self):
        with pytest.raises(ValueError, match="maxiter"):
            adaptive_interp.train_iterative(ALPHAS, small_state, InterpModel, maxiter=0)


class TestTrainRecursive:
    def test_runs(self):
        states, _info = adaptive_interp.train_recursive(
            np.linspace(0.5, 2.0, 31),
            factory_state=small_state,
            factory_statecollection=InterpModel,
            maxiter=4,
            tol=0.02,
            state_kws={"rng": 11},
        )
        assert len(states) >= 2
        assert all(states[i].alpha0 <= states[i + 1].alpha0 for i in range(len(states) - 1))
        pred = npy(InterpModelPiecewise(states).predict(1.0)).mean()
        assert abs(pred - float(idealgas.x_ave(1.0))) < 0.05


def test_check_polynomial_consistency():
    states = [small_state(b, rng=i) for i, b in enumerate([0.5, 1.0, 1.5, 2.0])]
    ps, models = adaptive_interp.check_polynomial_consistency(states, InterpModel)
    assert len(models) == 3 + 2  # adjacent pairs + skip pairs
    for p in ps.values():
        assert np.all((0.0 <= p) & (p <= 1.0))


def test_factory_state_seed_per_beta():
    """One ``rng`` gives each β its own samples (the seed mixes in the bits
    of float32(beta)), the same seed the same state; a generator counts by
    its initial seed."""
    a = small_state(1.0, rng=4)
    b = small_state(1.0, rng=4)
    c = small_state(1.5, rng=4)
    np.testing.assert_array_equal(npy(a.data.xave), npy(b.data.xave))
    assert not np.allclose(npy(a.data.xave), npy(c.data.xave))
    gen = torch.Generator().manual_seed(4)
    np.testing.assert_array_equal(npy(small_state(1.0, rng=gen).data.xave), npy(a.data.xave))
    assert a.data.xave.shape == (40,)


class TestRecursiveInterp:
    @pytest.fixture(scope="class")
    def trained(self):
        derivs = beta_xpan.factory_derivatives("x_ave", central=False)
        ri = RecursiveInterp(InterpModel, derivs, edge_beta=[0.5, 2.0], max_order=ORDER, tol=0.02, rng=5, nrep=40)

        def get_data(beta):
            (sub,) = split(ri.rng, 1)
            x, u = idealgas.generate_data((2_000, 500), beta, rng=sub)
            return tx.factory_data_values(uv=u, xv=x, order=ORDER)

        ri.get_data = get_data
        ri.recursive_train(0.5, 2.0, recurse_max=6)
        return ri

    def test_predict(self, trained):
        betas = np.array([0.7, 1.3, 1.9])
        exact = np.array([float(idealgas.x_ave(b)) for b in betas])
        np.testing.assert_allclose(np.squeeze(trained.predict(betas)), exact, atol=0.03)

    def test_out_of_bounds(self, trained):
        with pytest.raises(IndexError):
            trained.predict([0.1])

    def test_poly_consistency(self, trained):
        """With an interior state the p-values lie in [0, 1]; with none, the
        check refuses a single region, as the JAX test skips it."""
        if len(trained.states) <= 2:
            with pytest.raises(ValueError, match="Single interpolation region"):
                trained.check_poly_consistency()
            return
        for p in trained.check_poly_consistency():
            assert np.all((0.0 <= p) & (p <= 1.0))

    def test_sequential_train(self):
        derivs = beta_xpan.factory_derivatives("x_ave", central=False)
        ri = RecursiveInterp(InterpModel, derivs, edge_beta=[0.6, 1.8], max_order=ORDER, rng=8)

        def get_data(beta):
            (sub,) = split(ri.rng, 1)
            x, u = idealgas.generate_data((2_000, 500), beta, rng=sub)
            return tx.factory_data_values(uv=u, xv=x, order=ORDER)

        ri.get_data = get_data
        ri.sequential_train([0.6, 1.2, 1.8])
        assert len(ri.states) == 3
        assert abs(float(np.squeeze(ri.predict([1.0]))) - float(idealgas.x_ave(1.0))) < 0.05

    def test_default_get_data_is_raw(self):
        """The default source: 10^4 configurations of 1000 particles as raw
        moments of order ``max_order``."""
        ri = RecursiveInterp(InterpModel, None, edge_beta=[1.0, 2.0], max_order=2, rng=1)
        data = ri.get_data(1.0)
        assert not data.central
        assert tuple(data.uv.shape) == (10_000,)


class TestPlottingCallbacks:
    def test_callback_plot_progress(self):
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        _fig, ax = plt.subplots()
        model, info = adaptive_interp.train_iterative(
            np.linspace(0.5, 2.0, 11),
            factory_state=small_state,
            factory_statecollection=InterpModel,
            maxiter=2,
            callback=adaptive_interp.callback_plot_progress,
            callback_kws={"ax": ax, "verbose": False, "exact": idealgas.x_ave, "maxdepth_stop": 0},
            state_kws={"rng": 5},
        )
        assert model is not None
        assert len(ax.lines) >= 2
        assert len(info) <= 2
        plt.close("all")

    def test_plot_polynomial_consistency(self):
        matplotlib = pytest.importorskip("matplotlib")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        states = [small_state(b, rng=i) for i, b in enumerate((0.5, 1.2, 2.0))]
        _fig, ax = plt.subplots()
        ps, _models = adaptive_interp.plot_polynomial_consistency(
            np.linspace(0.5, 2.0, 16), states, InterpModel, ax=ax, verbose=False
        )
        assert len(ps) == 3
        assert all(np.all((0 <= np.asarray(p)) & (np.asarray(p) <= 1)) for p in ps.values())
        assert len(ax.lines) >= 3
        plt.close("all")


# -- tests/test_stack.py on the port ---------------------------------------------------


def test_to_mean_var(rng_np):
    arr = rng_np.normal(size=(4, 30, 2))
    out = stack.to_mean_var(arr, axis=1)
    assert out.shape == (4, 2, 2)
    np.testing.assert_allclose(out[..., 0], arr.mean(axis=1))
    np.testing.assert_allclose(out[..., 1], arr.var(axis=1))


def test_stacked_derivatives_roundtrip(rng_np):
    alphas = [0.5, 1.5]
    derivs = [rng_np.normal(size=(3, 20, 1)) for _ in alphas]
    sd = stack.StackedDerivatives.from_derivs(alphas, derivs)
    x, ys = sd.array_data()
    assert x.shape == (6, 2)
    assert len(ys) == 1
    assert ys[0].shape == (6, 2)
    np.testing.assert_allclose(x[:3, 0], 0.5)
    np.testing.assert_allclose(x[:, 1], [0, 1, 2, 0, 1, 2])
    np.testing.assert_allclose(ys[0][:3, 0], derivs[0].mean(axis=1)[:, 0])
    x2, _ys2 = sd.array_data(order=1)
    assert x2.shape == (4, 2)
    assert sd.order == 2
    ref = jstack.StackedDerivatives.from_derivs(alphas, derivs)
    np.testing.assert_allclose(sd.y_data, ref.y_data, rtol=RTOL)


def _ig_state(pkg, beta, seed, nconfig, npart, order=3):
    """The ideal-gas extrapolation state of ``gpr_active.ig_active.extrap_IG``
    (order 3, central, one value column) from numpy samples."""
    rng = np.random.default_rng(seed)
    pos = -np.log1p(-rng.random((nconfig, npart)) * (1.0 - np.exp(-beta))) / beta
    data = pkg.factory_data_values(uv=pos.sum(-1), xv=pos.mean(-1)[:, None], order=order, central=True)
    return (jb if pkg is jx else beta_xpan).factory_extrapmodel(beta, data)


def test_gprdata_staging():
    states = [_ig_state(tx, b, i, 1000, 200) for i, b in enumerate([0.8, 1.6])]
    gd = stack.GPRData(states, nrep=20)
    x, ys = gd.array_data()
    assert x.shape == (8, 2)  # 2 states x (order 3 + 1)
    assert ys[0].shape == (8, 2)
    assert gd.resample({"nrep": 3}).kws == {"order": None, "nrep": 20}


def test_states_derivs_concat():
    got = stack.states_derivs_concat([_ig_state(tx, b, i, 500, 100) for i, b in enumerate([0.9, 1.4])])
    ref = jstack.states_derivs_concat([_ig_state(jx, b, i, 500, 100) for i, b in enumerate([0.9, 1.4])])
    assert got.shape == (8, 1)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL)


def test_stack_multidim_semantics(rng_np):
    arr = rng_np.normal(size=(3, 4, 2, 5))
    dims = ("order", "cell", "comp", "stats")
    coords = {"order": np.arange(3), "cell": np.linspace(0.0, 1.0, 4)}
    out, xc, yc = stack.stack_multidim(arr, dims, x_dims=("order", "cell"), stats_dim="stats", coords=coords)
    assert out.shape == (12, 2, 5)
    assert xc.shape == (12, 2)
    assert yc.shape == (2, 1)
    for k in [0, 5, 11]:
        i, j = divmod(k, 4)
        np.testing.assert_allclose(out[k], arr[i, j])
        np.testing.assert_allclose(xc[k], [coords["order"][i], coords["cell"][j]])
    out2, xc2, _ = stack.stack_multidim(arr, dims, x_dims=("cell", "order"), stats_dim="stats")
    np.testing.assert_allclose(out2[1], arr[1, 0])
    np.testing.assert_allclose(xc2[1], [0, 1])
    with pytest.raises(ValueError, match="not set"):
        stack.stack_multidim(arr, dims, x_dims="order", policy="raise")
    with pytest.raises(ValueError, match="partition"):
        stack.stack_multidim(arr, dims, x_dims="order", y_dims=("cell",))


def test_multidim_observable_staging():
    """A (rec, 2, 3) observable stages into 6 output columns (the staging
    half of tests/test_stack.py:92; tests/test_torch_gpr_active.py holds the
    GP half)."""

    def mk(b, seed):
        rng = np.random.default_rng(seed)
        u = rng.normal(2.0, 1.0, 600)
        x = np.stack([0.1 * k + 0.3 * u + rng.normal(size=600) for k in range(6)], axis=1).reshape(600, 2, 3)
        return beta_xpan.factory_extrapmodel(b, tx.factory_data_values(uv=u, xv=x, order=2, central=True))

    sd = stack.StackedDerivatives.from_states([mk(0.8, 0), mk(1.6, 1)], nrep=15)
    x, ys = sd.array_data()
    assert x.shape == (6, 2)
    assert len(ys) == 6
    assert all(np.all(np.isfinite(y)) and np.all(y[:, 1] >= 0) for y in ys)

"""The active-learning half of the torch port's ``gpr_active.active_utils``
(update policies, stopping metrics, ``StopCriteria``, ``active_learning``,
``load_active_history``) and ``SimWrapper``'s processes against the JAX
package: the port's mirror of tests/test_active.py:82-372.

Parity: the two packages draw from different random streams, so

- a GP is built in both from one JAX-staged ``(X, Y, cov)`` and the port's
  model takes the JAX model's trained parameters: the policies then see the
  same posterior (to ~1e-12), and ``_uniform`` is patched in both packages
  to return the same numpy draws;
- the loops run in both packages on a simulator whose ``DataWrapper`` makes
  its numpy samples and its bootstrap's index table from a seed keyed on β,
  so every state is the same numpy data in both.

Bars: the acquired β equal; metrics of one posterior within 1e-10
relative; the loops' losses and stop metrics within rtol 1e-6 and their
final posteriors within 1e-3 of the posterior sigma (the bars of
tests/test_torch_gpr_active.py's ``create_GPR`` parity).
"""

import numpy as np
import pytest
import torch
from _torch_parity import npy
from _torch_sims import failing_sim, fake_sim

from thermoextrap_tpu import idealgas as jideal
from thermoextrap_tpu.gpr_active import active_utils as jau
from thermoextrap_tpu.gpr_active import gp_models as jgm
from thermoextrap_tpu_torch import idealgas
from thermoextrap_tpu_torch.gpr_active import active_utils as au
from thermoextrap_tpu_torch.gpr_active import gp_models, ig_active

NCONF, NPART, NREP = 2_000, 200, 100


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(beta, nconf=NCONF, npart=NPART):
    """Ideal-gas ``(u, x, index table)`` from a numpy seed keyed on beta."""
    rng = np.random.default_rng(int(round(float(beta) * 1e6)))
    pos = -np.log1p(-rng.random((nconf, npart)) * (1.0 - np.exp(-beta))) / beta
    return pos.sum(-1), pos.mean(-1), rng.integers(0, nconf, (NREP, nconf))


def _np_wrapper(pkg):
    """``pkg``'s ``DataWrapper`` whose data is :func:`_samples` and whose
    states bootstrap through its index table."""

    class NpWrapper(pkg.DataWrapper):
        def __init__(self, beta) -> None:
            self.beta = float(beta)

        def get_data(self):
            u, x, _idx = _samples(self.beta)
            return u, x[:, None], np.ones_like(u)

        def build_state(self, all_data=None, max_order: int = 6):
            state = super().build_state(all_data, max_order)
            idx = _samples(self.beta)[2]
            real = state.resample
            state.resample = lambda sampler, real=real: real({"indices": idx})
            return state

    return NpWrapper


class _NpSim:
    """A simulator handing out :func:`_np_wrapper` data wrappers."""

    def __init__(self, pkg) -> None:
        self.wrapper = _np_wrapper(pkg)
        self.calls = 0

    def run_sim(self, unused, beta, n_repeats=None, **_kws):
        self.calls += 1
        return self.wrapper(beta)


def _staged(betas):
    """JAX-staged GP inputs of :func:`_np_wrapper` states."""
    wrapper = _np_wrapper(jau)
    return [jau.input_GP_from_state(wrapper(b).build_state(max_order=3)) for b in betas]


def _pair(betas):
    """``(port model, JAX model)`` with the JAX model's trained parameters."""
    staged = _staged(betas)
    jgpr = jau.create_GPR([lambda d=d: d for d in staged])
    gpr = au.create_GPR([lambda d=d: d for d in staged])
    gpr.set_parameters(jgpr.parameters())
    return gpr, jgpr


@pytest.fixture(scope="module")
def ig_gpr():
    gpr, jgpr = _pair([1.0, 2.0])
    return gpr, jgpr, [1.0, 2.0]


@pytest.fixture
def same_uniform(monkeypatch):
    """``_uniform`` of both packages returns the same numpy draws."""

    def draws(self, n):
        self.calls = getattr(self, "calls", 0) + 1
        return np.random.default_rng(1000 * self.calls + n).random(n)

    monkeypatch.setattr(au.UpdateStopABC, "_uniform", draws)
    monkeypatch.setattr(jau.UpdateStopABC, "_uniform", draws)


def _assert_update(got, ref):
    assert got[0] == pytest.approx(float(ref[0]), rel=1e-12)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=1e-8)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=1e-6)


class TestUpdates:
    @pytest.mark.parametrize("name", ["UpdateALMbrute", "UpdateRandom", "UpdateSpaceFill"])
    @pytest.mark.parametrize("avoid_repeats", [False, True])
    def test_update_policies(self, ig_gpr, same_uniform, name, avoid_repeats):
        gpr, jgpr, alphas = ig_gpr
        got = getattr(au, name)(rng=0, n_grid=100, avoid_repeats=avoid_repeats)(gpr, alphas)
        ref = getattr(jau, name)(rng=0, n_grid=100, avoid_repeats=avoid_repeats)(jgpr, alphas)
        assert np.min(alphas) <= got[0] <= np.max(alphas)
        assert np.all(np.isfinite(got[1]))
        _assert_update(got, ref)

    def test_update_adaptive_integrate(self, ig_gpr, same_uniform):
        gpr, jgpr, alphas = ig_gpr
        got = au.UpdateAdaptiveIntegrate(tol=10.0, rng=0, n_grid=100)(gpr, alphas)
        ref = jau.UpdateAdaptiveIntegrate(tol=10.0, rng=0, n_grid=100)(jgpr, alphas)
        assert np.min(alphas) <= got[0] <= np.max(alphas)
        _assert_update(got, ref)
        with pytest.raises(RuntimeError, match="more simulation"):
            au.UpdateAdaptiveIntegrate(tol=1e-30, rng=0, n_grid=100)(gpr, alphas)

    def test_update_log_scale(self, ig_gpr, same_uniform):
        gpr, jgpr, alphas = ig_gpr
        got = au.UpdateSpaceFill(rng=0, n_grid=100, log_scale=True)(gpr, alphas)
        ref = jau.UpdateSpaceFill(rng=0, n_grid=100, log_scale=True)(jgpr, alphas)
        _assert_update(got, ref)
        np.testing.assert_allclose(got[0], 10 ** (0.5 * np.log10(2.0)))

    def test_update_alc(self, ig_gpr):
        gpr, jgpr, alphas = ig_gpr
        got = au.UpdateALCbrute(rng=0, n_grid=50, n_candidates=20)(gpr, alphas)
        ref = jau.UpdateALCbrute(rng=0, n_grid=50, n_candidates=20)(jgpr, alphas)
        assert np.min(alphas) <= got[0] <= np.max(alphas)
        _assert_update(got, ref)

    def test_alc_hypothetical_cov_in_original_units(self, ig_gpr, monkeypatch):
        """ALC rebuilds hypothetical models from ORIGINAL-unit y, so the
        stored (scale-divided) likelihood.cov must be rescaled by
        scale_fac**2 before it seeds them."""
        gpr, _jgpr, alphas = ig_gpr
        captured = {}
        real = au.create_base_GP_model

        def spy(data, **kws):
            captured.setdefault("cov", np.asarray(data[2]))
            return real(data, **kws)

        monkeypatch.setattr(au, "create_base_GP_model", spy)
        au.UpdateALCbrute(rng=0, n_grid=20, n_candidates=3)(gpr, alphas)
        n = np.asarray(gpr.likelihood.cov).shape[-1]
        want = np.asarray(gpr.likelihood.cov) * (npy(gpr.scale_fac).reshape(-1, 1, 1) ** 2)
        np.testing.assert_allclose(captured["cov"][:, :n, :n], want, rtol=1e-12)
        assert float(np.max(npy(gpr.scale_fac))) != 1.0

    def test_spacefill_midpoint(self, ig_gpr):
        gpr, _jgpr, alphas = ig_gpr
        new_alpha, _m, _s = au.UpdateSpaceFill(rng=0, n_grid=100)(gpr, alphas)
        np.testing.assert_allclose(new_alpha, 1.5, atol=0.02)

    def test_uniform_draws_from_a_generator(self):
        """``_uniform`` advances a ``torch.Generator``; equal seeds give
        equal draws, and the grid jitter stays within one grid step."""
        a, b = au.UpdateRandom(rng=4, n_grid=30, avoid_repeats=True), au.UpdateRandom(rng=4, n_grid=30)
        assert isinstance(a.rng, torch.Generator)
        first = a._uniform(5)
        np.testing.assert_array_equal(first, b._uniform(5))
        assert not np.array_equal(first, a._uniform(5))
        assert np.all((first >= 0) & (first < 1))
        grid, select = a.create_alpha_grid([1.0, 2.0])
        assert select.shape == (28,) and np.all(np.abs(select - grid[1:-1]) <= grid[1] - grid[0])


class TestMetrics:
    def fake_history(self):
        mu1 = np.linspace(0.0, 1.0, 10)[:, None]
        mu2 = mu1 + 0.01
        std = np.full_like(mu1, 0.05)
        return [np.stack([mu1, mu2]), np.stack([std, std * 0.5])]

    @pytest.mark.parametrize(
        "name",
        [
            "MaxVar",
            "AvgVar",
            "MaxRelVar",
            "AvgRelVar",
            "MaxRelGlobalVar",
            "MSD",
            "MaxAbsRelDeviation",
            "AvgAbsRelDeviation",
            "MaxAbsRelGlobalDeviation",
        ],
    )
    def test_metric_values_finite(self, name):
        val = getattr(au, name)(tol=0.1)(self.fake_history(), None, None)
        assert np.isfinite(val)
        assert val >= 0
        assert val == pytest.approx(float(getattr(jau, name)(tol=0.1)(self.fake_history(), None, None)), rel=1e-12)
        h1 = [a[:1] for a in self.fake_history()]
        assert getattr(au, name)(tol=0.1)(h1, None, None) == pytest.approx(float(getattr(jau, name)(tol=0.1)(h1, None, None)), rel=1e-12)

    def test_maxiter_never_stops(self):
        m = au.MaxIter()
        assert m(self.fake_history(), None, None) > m.tol

    def test_max_var_value(self):
        assert au.MaxVar(tol=1)(self.fake_history(), None, None) == 0.025

    def test_history_is_checked(self):
        with pytest.raises(ValueError, match="history"):
            au.MaxVar(tol=1)(None, None, None)

    def test_error_stability(self, ig_gpr):
        gpr, _jgpr, _ = ig_gpr
        # two states: two locations at order 0, so the metric is 1.0
        assert au.ErrorStability(tol=0.1).calc_metric(None, None, gpr) == 1.0


def test_error_stability_full_kl_path():
    """Three states reach the full KL / Lambert-W path: the first call
    normalizes to 1.0, and the normalization (the two KL terms' Lambert-W
    sum) equals the JAX package's on the same posterior."""
    gpr, jgpr = _pair([0.6, 1.2, 1.8])
    m, jm = au.ErrorStability(tol=0.1), jau.ErrorStability(tol=0.1)
    assert m.calc_metric(None, None, gpr) == pytest.approx(1.0)
    jm.calc_metric(None, None, jgpr)
    assert np.isfinite(m.r1) and m.r1 > 0
    assert m.r1 == pytest.approx(float(jm.r1), rel=1e-6)
    v2 = m.calc_metric(None, None, gpr)
    assert np.isfinite(v2) and v2 > 0


class TestStopCriteria:
    def test_stop_criteria_history(self, ig_gpr):
        gpr, jgpr, alphas = ig_gpr
        sc = au.StopCriteria([au.MaxRelVar(tol=1e10), au.MaxRelGlobalVar(tol=1e10), au.MaxIter()], n_grid=50)
        jsc = jau.StopCriteria([jau.MaxRelVar(tol=1e10), jau.MaxRelGlobalVar(tol=1e10), jau.MaxIter()], n_grid=50)
        stop, metrics = sc(gpr, alphas)
        jstop, jmetrics = jsc(jgpr, alphas)
        assert not stop and not jstop  # MaxIter never passes
        assert metrics.keys() == jmetrics.keys()
        for k in metrics:
            assert metrics[k] == pytest.approx(float(jmetrics[k]), rel=1e-10)
        assert sc.history[0].shape[0] == 1
        sc(gpr, alphas)
        jsc(jgpr, alphas)
        assert sc.history[0].shape == (2, 50, 1)
        for h, jh in zip(sc.history, jsc.history):
            np.testing.assert_allclose(h, np.asarray(jh), rtol=1e-8)


# -- the loop, end to end ---------------------------------------------------------------


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The same ALM loop in both packages on :class:`_NpSim` data, each
    saving its history."""
    out = {}
    for name, pkg in (("port", au), ("jax", jau)):
        base = tmp_path_factory.mktemp(name)
        sim = _NpSim(pkg)
        update = pkg.UpdateALMbrute(rng=1, n_grid=60)
        stop = pkg.StopCriteria([pkg.MaxRelGlobalVar(tol=1e-6), pkg.MaxVar(tol=1e-12)], n_grid=60)
        data_list, history = pkg.active_learning(
            [0.5, 2.0], sim, update, base_dir=str(base), stop_criteria=stop, max_iter=2, max_order=3, save_history=True
        )
        out[name] = {"data": data_list, "history": history, "stop": stop, "sim": sim, "npz": base / "active_history.npz"}
    return out


def test_ig_loop_matches_jax(loops):
    port, ref = loops["port"], loops["jax"]
    betas = [d.beta for d in port["data"]]
    assert betas == [d.beta for d in ref["data"]]
    assert len(betas) == 4 and port["sim"].calls == 4
    hist, jhist = port["history"], ref["history"]
    assert all(type(v) is float for v in hist["loss"])
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-6)
    for name in ("MaxRelGlobalVar", "MaxVar"):
        np.testing.assert_allclose(hist[name], np.asarray(jhist[name], dtype=float), rtol=1e-6)
    assert port["stop"].history[0].shape[0] == len(hist["loss"]) == 3


def test_ig_loop_final_posteriors_match_jax(loops):
    staged = [jau.input_GP_from_state(d.build_state(max_order=3)) for d in loops["jax"]["data"]]
    gpr = au.create_GPR([lambda d=d: d for d in staged], start_params=loops["port"]["history"]["params"][-1])
    jgpr = jau.create_GPR([lambda d=d: d for d in staged], start_params=loops["jax"]["history"]["params"][-1])
    for order in (0, 1):
        xt = np.column_stack([np.linspace(0.5, 2.0, 9), np.full(9, float(order))])
        mean, _ = (npy(a) for a in gpr.predict_f(xt))
        jmean, jvar = (np.asarray(a) for a in jgpr.predict_f(xt))
        assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))


@pytest.mark.parametrize(("reader", "writer"), [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_history_npz_read_by_either_package(loops, reader, writer):
    """Each package reads the other's ``active_history.npz``, and its last
    parameters warm-start ``create_GPR``."""
    pkg = au if reader == "port" else jau
    hist = pkg.load_active_history(loops[writer]["npz"])
    n_it = len(loops[writer]["history"]["loss"])
    assert hist["loss"].shape == (n_it,)
    assert len(hist["params"]) == n_it
    assert hist["params"][-1] == pytest.approx(loops[writer]["history"]["params"][-1])
    assert set(hist) == {"pred_mu", "pred_std", "alpha", "loss", "params", "MaxRelGlobalVar", "MaxVar"}
    assert hist["pred_mu"].shape[0] == n_it
    np.testing.assert_allclose(hist["alpha"], [d.beta for d in loops[writer]["data"]])
    states = [_np_wrapper(pkg)(b).build_state(max_order=3) for b in hist["alpha"]]
    gpr2 = pkg.create_GPR(states, start_params=hist["params"][-1])
    assert np.isfinite(float(npy(gpr2.neg_lml(gpr2.get_unconstrained()))))


def test_ig_loop_analytical_scale_model(tmp_path, same_uniform):
    """``gp_base_kwargs`` plumbs a swapped GP model class through the whole
    loop (the analytical-noise-scale variant), as in the JAX package."""
    out = []
    for pkg, gm in ((au, gp_models), (jau, jgm)):
        update = pkg.UpdateSpaceFill(rng=2, n_grid=40)
        stop = pkg.StopCriteria([pkg.MaxRelGlobalVar(tol=1e-6)], n_grid=40)
        data_list, history = pkg.active_learning(
            [0.5, 2.0],
            _NpSim(pkg),
            update,
            base_dir=str(tmp_path),
            stop_criteria=stop,
            max_iter=1,
            max_order=3,
            gp_base_kwargs={"model_class": gm.HeteroscedasticGPRAnalyticalScale},
        )
        out.append(([d.beta for d in data_list], history["loss"]))
    assert out[0][0] == out[1][0]
    assert np.all(np.isfinite(out[0][1]))
    np.testing.assert_allclose(out[0][1], np.asarray(out[1][1]), rtol=1e-6)


def test_prediction_quality_after_loop(tmp_path):
    sim = ig_active.SimulateIG(nconfig=4_000, npart=500)
    update = au.UpdateSpaceFill(rng=2, n_grid=60)
    data_list, _ = au.active_learning([0.5, 2.0], sim, update, base_dir=str(tmp_path), max_iter=1, max_order=2)
    states = [d.build_state(max_order=2) for d in data_list]
    gpr = au.create_GPR(states)
    xt = np.linspace(0.6, 1.9, 7)
    mu, _var = gpr.predict_f(np.stack([xt, np.zeros_like(xt)], axis=1))
    exact = npy(idealgas.x_ave(torch.tensor(xt)))
    np.testing.assert_allclose(npy(mu)[:, 0], exact, atol=0.05)
    np.testing.assert_allclose(exact, [float(jideal.x_ave(b)) for b in xt], rtol=1e-12)


def test_loop_rejects_bad_init_state():
    with pytest.raises(TypeError, match="init state"):
        au.active_learning(["x"], _NpSim(au), au.UpdateALMbrute(), max_iter=0)


class TestActiveLearningRestart:
    def test_restart_from_data_wrappers(self, tmp_path):
        """A second ``active_learning`` call seeded with the DataWrapper list
        of a previous run continues without re-simulating the initial
        states."""
        sim = ig_active.SimulateIG(nconfig=NCONF, npart=NPART)
        update = au.UpdateSpaceFill(rng=3, n_grid=50)
        data_list, _ = au.active_learning([0.5, 2.0], sim, update, base_dir=str(tmp_path), max_iter=1, max_order=2)
        n_first = len(data_list)
        counter_after_first = sim._counter
        data_list2, history2 = au.active_learning(data_list, sim, update, base_dir=str(tmp_path), max_iter=1, max_order=2)
        assert len(data_list2) >= n_first
        assert sim._counter == counter_after_first + 1
        assert len(history2["loss"]) >= 1


# -- SimWrapper's processes -------------------------------------------------------------


class TestSimWrapperProcesses:
    def test_run_sim_spawns_and_wraps(self, tmp_path):
        """SimWrapper spawns n_repeats child processes, joins, checks exit
        codes, and wraps the output files; the JAX package's DataWrapper
        reads the same files to the same samples."""
        sw = au.SimWrapper(fake_sim, data_kw_inputs={"n_frames": 500})
        dw = sw.run_sim(tmp_path / "beta_1.0", 1.0, n_repeats=2)
        assert isinstance(dw, au.DataWrapper)
        assert len(dw.sim_info_files) == 2
        pot, x, w = dw.get_data()
        assert pot.shape[0] == x.shape[0] == w.shape[0] > 0
        jdw = jau.DataWrapper(dw.sim_info_files, dw.cv_bias_files, 1.0, n_frames=500)
        for g, r in zip((pot, x, w), jdw.get_data()):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-12)
        state = dw.build_state(max_order=2)
        pred = float(npy(state.predict(1.0))[0])
        assert abs(pred - float(idealgas.x_ave(1.0))) < 0.05

    def test_failing_sim_raises(self, tmp_path):
        sw = au.SimWrapper(failing_sim)
        with pytest.raises(RuntimeError, match="exited with code"):
            sw.run_sim(tmp_path / "beta_2.0", 2.0, n_repeats=1)

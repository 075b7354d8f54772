"""MBAR of the torch port against the JAX package, on the CPU (float64 on both
sides): the hybrid solver, the reweighting grids, both uncertainty
estimators, ``statistical_inefficiency`` and ``MBARModel``.

Mirrors ``tests/test_mbar.py`` (TestHybridSolver, TestGridExpectations,
TestUncertainties, TestAlphaChunked), ``tests/test_models.py``
(TestStatisticalInefficiency, TestMBAR) and the subsample case of
``tests/test_series.py``, each at the JAX test's own inputs and bars, plus
port-against-JAX cases on the same numpy inputs: the solve (hybrid and sci)
and the covariance at rtol 1e-10, the bootstrap fed the JAX package's own
Poisson counts at rtol 1e-9, the masked (``-inf``) seam, ``MBARModel``.

Not mirrored: ``test_alphas_jittable`` (the port has no tracing; the α blocks
are a Python loop, checked against the grid by ``test_alphas_matches_grid``).
TestShardedMBAR is mirrored in ``tests/test_torch_parallel.py``, on a world
of 4 gloo ranks.
"""

import doctest

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import idealgas as jideal
from thermoextrap_tpu.models import mbar as jm
from thermoextrap_tpu.models.extrap import MBARModel as JMBARModel
from thermoextrap_tpu.ops.resample import poisson1_freq as jpoisson1_freq
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch.models import mbar as tm
from thermoextrap_tpu_torch.models.extrap import MBARModel

RTOL = 1e-10


def _harmonic_problem(sigmas, n, seed=0, dtype=np.float64):
    """K harmonic states u_k(x) = x^2 / (2 sigma_k^2), samples from each;
    f_k - f_0 = -log(sigma_k / sigma_0) exactly."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(0.0, s, size=n) for s in sigmas])
    sig = np.asarray(sigmas, dtype=dtype)
    u_kn = (xs[None, :] ** 2 / (2.0 * sig[:, None] ** 2)).astype(dtype)
    n_k = np.full(len(sigmas), float(n))
    return u_kn, n_k, xs, -np.log(sig / sig[0])


# -- tests/test_mbar.py::TestHybridSolver ----------------------------------------------------


class TestHybridSolver:
    def test_matches_analytic_free_energies(self):
        u_kn, n_k, _, f_exact = _harmonic_problem([1.0, 1.6, 2.5, 4.0], 40000)
        np.testing.assert_allclose(npy(tm.mbar_solve(u_kn, n_k)), f_exact, atol=0.03)

    def test_hybrid_equals_fixed_point(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 1.5, 2.2], 3000, seed=1)
        f_h = npy(tm.mbar_solve(u_kn, n_k, method="hybrid", tol=1e-13))
        f_s = npy(tm.mbar_solve(u_kn, n_k, method="sci", tol=1e-14))
        np.testing.assert_allclose(f_h, f_s, atol=1e-10)

    def test_residual_converged_and_fewer_iterations(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 6.0, 30.0], 4000, seed=2)
        f_h, it_h, res_h = tm.mbar_solve_info(u_kn, n_k, tol=1e-12)
        f_s, it_s, res_s = tm.mbar_solve_info(u_kn, n_k, tol=1e-12, method="sci", max_iter=20000)
        assert isinstance(it_h, int) and float(res_h) <= 1e-12
        assert it_h < 60
        assert it_h * 5 < it_s, (it_h, it_s)
        np.testing.assert_allclose(npy(f_h), npy(f_s), atol=1e-8)

    def test_two_states_known_offset(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=500)
        u0 = 0.5 * np.concatenate([x, x + 0.3]) ** 2
        c = -2.4
        f = npy(tm.mbar_solve(np.stack([u0, u0 + c]), np.array([500.0, 500.0])))
        np.testing.assert_allclose(f[1] - f[0], c, rtol=1e-9)

    def test_f32_default_tol_converges(self):
        u_kn, n_k, _, f_exact = _harmonic_problem([1.0, 1.8, 3.0], 20000, seed=4, dtype=np.float32)
        f, _it, res = tm.mbar_solve_info(u_kn.astype(np.float32), n_k)
        assert f.dtype == torch.float32
        assert float(res) <= 1e-5
        np.testing.assert_allclose(npy(f), f_exact, atol=0.05)

    def test_bad_method_raises(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 2.0], 64)
        with pytest.raises(ValueError, match="unknown MBAR method"):
            tm.mbar_solve(u_kn, n_k, method="nope")


# -- tests/test_mbar.py::TestGridExpectations --------------------------------------------------


class TestGridExpectations:
    def test_grid_matches_per_target_loop(self):
        u_kn, n_k, xs, _ = _harmonic_problem([1.0, 2.0, 3.0], 2000, seed=5)
        f = tm.mbar_solve(u_kn, n_k)
        x_n = np.stack([xs, xs**2], axis=1)
        scales = np.array([0.7, 1.0, 1.9])
        u_targets = xs[None, :] ** 2 / (2.0 * scales[:, None] ** 2)
        grid = npy(tm.mbar_expectations_grid(u_kn, n_k, f, u_targets, x_n))
        for a in range(len(scales)):
            np.testing.assert_allclose(grid[a], npy(tm.mbar_expectations(u_kn, n_k, f, u_targets[a], x_n)), rtol=1e-12)
        assert_close(grid, jm.mbar_expectations_grid(u_kn, n_k, npy(f), u_targets, x_n), RTOL)

    def test_target_moments_match_analytic(self):
        u_kn, n_k, xs, _ = _harmonic_problem([1.0, 1.5, 2.5], 60000, seed=6)
        f = tm.mbar_solve(u_kn, n_k)
        sig_t = 1.8
        u_t = xs[None, :] ** 2 / (2.0 * sig_t**2)
        got = npy(tm.mbar_expectations_grid(u_kn, n_k, f, u_t, xs[:, None] ** 2))
        np.testing.assert_allclose(got[0, 0], sig_t**2, rtol=0.05)

    def test_log_weights_normalized(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 2.0], 512, seed=7)
        f = tm.mbar_solve(u_kn, n_k)
        logw = npy(tm.mbar_log_weights(u_kn, n_k, f, u_kn[0]))
        np.testing.assert_allclose(np.exp(logw).sum(), 1.0, rtol=1e-12)
        assert_close(logw, jm.mbar_log_weights(u_kn, n_k, npy(f), u_kn[0]), RTOL)


# -- tests/test_mbar.py::TestUncertainties -----------------------------------------------------


class TestUncertainties:
    def test_covariance_matches_bootstrap_fe(self):
        sigmas, n = [1.0, 1.8, 3.0], 4000
        u_kn, n_k, _, _ = _harmonic_problem(sigmas, n, seed=20)
        dfe = tm.mbar_fe_uncertainties(tm.mbar_covariance(u_kn, n_k, tm.mbar_solve(u_kn, n_k)))
        assert isinstance(dfe, np.ndarray)
        redraws = np.array([npy(tm.mbar_solve(*_harmonic_problem(sigmas, n, seed=100 + s)[:2])) for s in range(40)])
        emp = redraws.std(axis=0, ddof=1)
        for k in (1, 2):
            assert 0.5 < dfe[0, k] / emp[k] < 2.0, (dfe[0, k], emp[k])

    def test_covariance_gauge_row(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 2.0], 2000, seed=21)
        dfe = tm.mbar_fe_uncertainties(tm.mbar_covariance(u_kn, n_k, tm.mbar_solve(u_kn, n_k)))
        assert dfe.shape == (2, 2)
        np.testing.assert_allclose(np.diag(dfe), 0.0, atol=1e-12)
        assert dfe[0, 1] > 0

    def test_bootstrap_expectations_statistical(self):
        sigmas, n = [1.0, 2.0], 3000
        u_kn, n_k, xs, _ = _harmonic_problem(sigmas, n, seed=22)
        f = tm.mbar_solve(u_kn, n_k)
        sig_t = 1.5
        u_t = xs[None, :] ** 2 / (2.0 * sig_t**2)
        x_n = xs[:, None] ** 2
        point = npy(tm.mbar_expectations_grid(u_kn, n_k, f, u_t, x_n))
        mean, std = tm.mbar_bootstrap_expectations(u_kn, n_k, u_t, x_n, nrep=48, rep_chunk=8, rng=None)
        np.testing.assert_allclose(npy(mean), point, rtol=0.02)
        draws = []
        for s in range(24):
            u_s, nk_s, xs_s, _ = _harmonic_problem(sigmas, n, seed=200 + s)
            f_s = tm.mbar_solve(u_s, nk_s)
            ut_s = xs_s[None, :] ** 2 / (2.0 * sig_t**2)
            draws.append(npy(tm.mbar_expectations_grid(u_s, nk_s, f_s, ut_s, xs_s[:, None] ** 2)))
        emp = float(np.array(draws).std(axis=0, ddof=1).squeeze())
        boot = float(npy(std).squeeze())
        assert 0.4 < boot / emp < 2.5, (boot, emp)

    def test_predict_ci_idealgas(self):
        states = []
        for i, b in enumerate([0.8, 1.2]):
            x, u = jideal.generate_data((3000, 10), b, rng=i)
            data = tx.DataValues.from_vals(np.asarray(x)[:, None], np.asarray(u), order=0, central=False)
            states.append(tbeta.factory_extrapmodel(b, data, order=0))
        mbar = MBARModel(states)
        mean, std = mbar.predict_ci(1.0, nrep=32)
        exact = float(jideal.x_ave(1.0))
        assert abs(float(mean[0]) - exact) < 0.05
        s = float(std[0])
        assert 0 < s < 0.05
        point = float(mbar.predict(1.0)[0])
        assert abs(point - float(mean[0])) < 4 * s + 1e-3

    def test_perturbed_free_energies_analytic(self):
        u_kn, n_k, xs, _ = _harmonic_problem([1.0, 1.5, 2.5], 60000, seed=25)
        f = tm.mbar_solve(u_kn, n_k)
        sig_t = np.array([1.2, 1.8, 2.2])
        u_t = xs[None, :] ** 2 / (2.0 * sig_t[:, None] ** 2)
        np.testing.assert_allclose(npy(tm.mbar_perturbed_free_energies(u_kn, n_k, f, u_t)), -np.log(sig_t), atol=0.02)
        same = npy(tm.mbar_perturbed_free_energies(u_kn, n_k, f, u_kn[1:2]))
        np.testing.assert_allclose(same[0], npy(f)[1], atol=1e-10)

    def test_overlap_matrix(self):
        u_kn, n_k, _, _ = _harmonic_problem([1.0, 1.3], 4000, seed=30)
        o = npy(tm.mbar_overlap(u_kn, n_k, tm.mbar_solve(u_kn, n_k)))
        np.testing.assert_allclose(o.sum(axis=1), 1.0, rtol=1e-8)
        assert o.min() > 0.1
        u_kn2, n_k2, _, _ = _harmonic_problem([1.0, 200.0], 4000, seed=31)
        o2 = npy(tm.mbar_overlap(u_kn2, n_k2, tm.mbar_solve(u_kn2, n_k2)))
        np.testing.assert_allclose(o2.sum(axis=1), 1.0, rtol=1e-8)
        assert o2[0, 1] < 0.05 and o2[0, 1] < o[0, 1] / 10

    def test_resample_still_raises(self):
        with pytest.raises(NotImplementedError, match="predict_ci"):
            MBARModel([]).resample(None)


# -- tests/test_mbar.py::TestAlphaChunked -----------------------------------------------------


def test_alphas_matches_grid():
    u_kn, n_k, xs, _ = _harmonic_problem([1.0, 2.0, 3.0], 2000, seed=11)
    f = tm.mbar_solve(u_kn, n_k)
    u_base = xs**2
    alphas = np.linspace(0.3, 1.4, 13)  # not a multiple of the chunk
    x_n = np.stack([xs, xs**2], axis=1)
    got = npy(tm.mbar_expectations_alphas(u_kn, n_k, f, alphas, u_base, x_n, chunk=4))
    want = npy(tm.mbar_expectations_grid(u_kn, n_k, f, alphas[:, None] * u_base[None, :], x_n))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert_close(got, jm.mbar_expectations_alphas(u_kn, n_k, npy(f), alphas, u_base, x_n, chunk=4), RTOL)


# -- tests/test_models.py::TestStatisticalInefficiency, TestMBAR; tests/test_series.py:101 --


def test_statistical_inefficiency_cross_form():
    rng = np.random.default_rng(0)
    n = 6000
    white1 = rng.normal(size=n)
    white2 = rng.normal(size=n)
    g12 = float(tm.statistical_inefficiency(white1, white2))
    assert g12 == float(tm.statistical_inefficiency(white2, white1))
    assert g12 < 2.0
    g_auto = float(tm.statistical_inefficiency(white1))
    np.testing.assert_allclose(float(tm.statistical_inefficiency(white1, white1)), g_auto, rtol=1e-10)
    ar = np.empty(n)
    ar[0] = 0.0
    eps = rng.normal(size=n)
    for t in range(1, n):
        ar[t] = 0.9 * ar[t - 1] + eps[t]
    assert float(tm.statistical_inefficiency(ar, 0.5 * ar + 1.0)) > 8.0
    g_anti = float(tm.statistical_inefficiency(ar, -ar))
    assert np.isfinite(g_anti) and g_anti >= 1.0
    # port against JAX, each form
    for args in ((white1,), (white1, white2), (ar,), (ar, 0.5 * ar + 1.0), (ar, -ar)):
        np.testing.assert_allclose(float(tm.statistical_inefficiency(*args)), float(jm.statistical_inefficiency(*args)), rtol=RTOL)


def test_statistical_inefficiency_doctest_and_types():
    """The reference docstring's example is this module's doctest; the type
    rule is ``result_type(x, float32)``: integers and float32 give float32,
    float64 stays float64."""
    result = doctest.testmod(tm, optionflags=doctest.ELLIPSIS, verbose=False)
    assert result.attempted >= 7 and result.failed == 0
    assert tm.statistical_inefficiency(np.arange(50) % 7).dtype == torch.float32
    assert tm.statistical_inefficiency(np.arange(50.0).astype(np.float32) % 7).dtype == torch.float32
    assert tm.statistical_inefficiency(np.arange(50.0) % 7).dtype == torch.float64
    # a zero-variance series has no decorrelation signal: g = 1
    assert float(tm.statistical_inefficiency(np.ones(20))) == 1.0


def test_subsample_correlated_data():
    idx = tm.subsample_correlated_data(np.zeros(100), g=9.2)
    assert isinstance(idx, np.ndarray)
    np.testing.assert_array_equal(idx, np.arange(0, 100, 10))
    rng = np.random.default_rng(0)
    x = rng.normal(size=500)
    idx2 = tm.subsample_correlated_data(x)
    assert len(idx2) > 400
    np.testing.assert_array_equal(idx2, jm.subsample_correlated_data(x))
    np.testing.assert_array_equal(tm.subsample_correlated_data(tt(x)), idx2)  # a tensor too


def _ig_states(betas, shape, both: bool = False):
    """Ideal-gas states of order 0 in the port (and in the JAX package)."""
    tstates, jstates = [], []
    for i, b in enumerate(betas):
        x, u = jideal.generate_data(shape, b, rng=i)
        x, u = np.asarray(x)[:, None], np.asarray(u)
        tstates.append(tbeta.factory_extrapmodel(b, tx.DataValues.from_vals(x, u, order=0, central=False), order=0))
        if both:
            jstates.append(jbeta.factory_extrapmodel(b, jx.DataValues.from_vals(x, u, order=0, central=False), order=0))
    return tstates, jstates


def test_mbar_model_ig_statistical():
    """tests/test_models.py::TestMBAR::test_ig_statistical (slow there, for
    its JAX compile; a fraction of a second here)."""
    tstates, _ = _ig_states([0.8, 1.2], (2000, 10))
    got = npy(MBARModel(tstates).predict(1.0))
    assert abs(got[0] - float(jideal.x_ave(1.0))) < 0.02


def test_mbar_solver_two_state_exact():
    rng = np.random.default_rng(0)
    n = 400
    x0 = rng.normal(size=n)
    x1 = rng.normal(size=n)
    c = 1.7
    u_kn = np.stack([0.5 * np.concatenate([x0, x1]) ** 2, 0.5 * np.concatenate([x0, x1]) ** 2 + c])
    f = npy(tm.mbar_solve(u_kn, np.array([n, n])))
    np.testing.assert_allclose(f[1] - f[0], c, rtol=1e-6)


# -- the port against the JAX package on the same inputs ----------------------------------------


@pytest.mark.parametrize("method", ["hybrid", "sci"])
def test_solve_matches_jax(method):
    u_kn, n_k, _, _ = _harmonic_problem([1.0, 1.6, 2.5, 4.0], 2500, seed=40)
    f, it, res = tm.mbar_solve_info(u_kn, n_k, method=method)
    fj, itj, resj = jm.mbar_solve_info(u_kn, n_k, method=method)
    assert_close(f, fj, RTOL, 1e-14)
    assert it == int(itj) and f.device.type == "cpu" and res.device.type == "cpu"
    assert float(res) <= 1e-12 or method == "sci"
    # one state: the fixed point, whatever the method
    f1, it1, _ = tm.mbar_solve_info(u_kn[:1], n_k[:1], method="nope")
    assert npy(f1).tolist() == [0.0] and it1 == int(jm.mbar_solve_info(u_kn[:1], n_k[:1])[1])


def test_covariance_matches_jax():
    for sig, n, seed in (([1.0, 1.6, 2.5, 4.0], 4000, 0), ([1.0, 2.0], 2000, 21)):
        u_kn, n_k, _, _ = _harmonic_problem(sig, n, seed=seed)
        f = npy(jm.mbar_solve(u_kn, n_k))
        theta = tm.mbar_covariance(u_kn, n_k, f)
        assert theta.dtype == torch.float64
        theta_j = jm.mbar_covariance(u_kn, n_k, f)
        assert_close(theta, theta_j, RTOL, 1e-20)
        assert_close(tm.mbar_fe_uncertainties(theta), jm.mbar_fe_uncertainties(theta_j), RTOL, 1e-14)
        assert_close(tm.mbar_overlap(u_kn, n_k, f), jm.mbar_overlap(u_kn, n_k, f), RTOL)


def test_covariance_cuts_the_gauge_mode():
    """The reference's pinv cut-off (numpy's 1e-15) sometimes keeps the
    gauge mode's rounding-level singular value and divides by it (here
    |Theta| ~ 4e10 and an asymmetric d(f)); the port cuts at sqrt(eps) and
    gives a finite, symmetric d(f) near the other seeds' values."""
    u_kn, n_k, _, _ = _harmonic_problem([1.0, 1.6, 2.5, 4.0], 4000, seed=1)
    f = npy(jm.mbar_solve(u_kn, n_k))
    theta_j = jm.mbar_covariance(u_kn, n_k, f)
    assert np.abs(theta_j).max() > 1e6  # the reference's fault on this input
    dfe = tm.mbar_fe_uncertainties(tm.mbar_covariance(u_kn, n_k, f))
    np.testing.assert_allclose(dfe, dfe.T, rtol=1e-12)
    u0, n0, _, _ = _harmonic_problem([1.0, 1.6, 2.5, 4.0], 4000, seed=0)
    dfe0 = tm.mbar_fe_uncertainties(tm.mbar_covariance(u0, n0, npy(jm.mbar_solve(u0, n0))))
    np.testing.assert_allclose(dfe, dfe0, rtol=0.2)


def test_grids_and_perturbed_match_jax():
    u_kn, n_k, xs, _ = _harmonic_problem([1.0, 1.7, 2.6], 1500, seed=41)
    f = npy(jm.mbar_solve(u_kn, n_k))
    u_t = xs[None, :] ** 2 / (2.0 * np.array([0.9, 1.4, 2.2, 2.9])[:, None] ** 2)
    x_n = np.stack([xs, xs**2, np.cos(xs)], axis=1)
    assert_close(tm.mbar_expectations_grid(u_kn, n_k, f, u_t, x_n), jm.mbar_expectations_grid(u_kn, n_k, f, u_t, x_n), RTOL)
    assert_close(tm.mbar_expectations(u_kn, n_k, f, u_t[1], x_n), jm.mbar_expectations(u_kn, n_k, f, u_t[1], x_n), RTOL)
    assert_close(tm.mbar_perturbed_free_energies(u_kn, n_k, f, u_t), jm.mbar_perturbed_free_energies(u_kn, n_k, f, u_t), RTOL)
    # 1-D x_n: the alphas path promotes it to one column, the grid keeps (A,)
    assert_close(
        tm.mbar_expectations_alphas(u_kn, n_k, f, [0.5, 0.8, 1.1], xs**2, xs, chunk=2),
        jm.mbar_expectations_alphas(u_kn, n_k, f, np.array([0.5, 0.8, 1.1]), xs**2, xs, chunk=2),
        RTOL,
    )
    assert_close(tm.mbar_expectations_grid(u_kn, n_k, f, u_t, xs), jm.mbar_expectations_grid(u_kn, n_k, f, u_t, xs), RTOL)


def test_masked_samples_match_jax():
    """``log_sample_weight = -inf`` drops samples: weighted and masked
    problems (``n_k`` the blocks' weight sums) solve, reweight and give the
    covariance as the reference does; padded columns under a ``-inf`` mask
    (the sharded wrapper's seam) leave the solve unchanged; and
    ``logsumexp`` of an all ``-inf`` row is ``-inf`` in both packages."""
    from jax.scipy.special import logsumexp

    rows = np.array([[-np.inf, -np.inf, -np.inf], [0.0, -np.inf, 1.0], [-np.inf, 2.0, -np.inf]])
    np.testing.assert_array_equal(npy(torch.logsumexp(tt(rows), dim=1)), np.asarray(logsumexp(rows, axis=1)))
    u_kn, _, xs, _ = _harmonic_problem([1.0, 1.9, 2.7], 1200, seed=42)
    lsw = np.zeros(u_kn.shape[1])
    lsw[::7] = -np.inf
    lsw[5::11] = np.log(2.0)
    n_k = np.exp(lsw).reshape(3, 1200).sum(axis=1)
    f, it, res = tm.mbar_solve_info(u_kn, n_k, log_sample_weight=lsw)
    fj, itj, _ = jm.mbar_solve_info(u_kn, n_k, log_sample_weight=lsw)
    assert float(res) <= 1e-12 and it == int(itj)
    assert_close(f, fj, RTOL, 1e-14)
    u_t = xs[None, :] ** 2 / (2.0 * np.array([1.3, 2.1])[:, None] ** 2)
    x_n = np.stack([xs, xs**2], axis=1)
    assert_close(
        tm.mbar_expectations_grid(u_kn, n_k, f, u_t, x_n, log_sample_weight=lsw),
        jm.mbar_expectations_grid(u_kn, n_k, npy(f), u_t, x_n, log_sample_weight=lsw),
        RTOL,
    )
    assert_close(
        tm.mbar_perturbed_free_energies(u_kn, n_k, f, u_t, log_sample_weight=lsw),
        jm.mbar_perturbed_free_energies(u_kn, n_k, npy(f), u_t, log_sample_weight=lsw),
        RTOL,
    )
    assert_close(
        tm.mbar_covariance(u_kn, n_k, f, log_sample_weight=lsw),
        jm.mbar_covariance(u_kn, n_k, npy(f), log_sample_weight=lsw),
        RTOL,
        1e-20,
    )
    # five padded columns, masked out, with the true n_k
    n_true = np.full(3, 1200.0)
    u_pad = np.concatenate([u_kn, np.full((3, 5), 7.0)], axis=1)
    mask = np.concatenate([np.zeros(u_kn.shape[1]), np.full(5, -np.inf)])
    f_pad = tm.mbar_solve(u_pad, n_true, log_sample_weight=mask)
    assert_close(f_pad, tm.mbar_solve(u_kn, n_true), 1e-12, 1e-14)
    assert_close(f_pad, jm.mbar_solve(u_pad, n_true, log_sample_weight=mask), RTOL, 1e-14)


def test_bootstrap_core_matches_jax_on_its_counts():
    """The bootstrap core, fed the JAX package's own Poisson counts (its key
    sequence: ``split(key, nrep + pad)``, one ``poisson1_freq`` per key),
    gives the reference's mean and std; the batched solve with its frozen
    replicates equals a solve of each replicate alone."""
    import jax

    u_kn, n_k, xs, _ = _harmonic_problem([1.0, 1.6, 2.4], 800, seed=43)
    u_t = xs[None, :] ** 2 / (2.0 * np.array([1.2, 1.9])[:, None] ** 2)
    x_n = np.stack([xs, xs**2], axis=1)
    nrep, rep_chunk = 20, 8
    mj, sj = jm.mbar_bootstrap_expectations(u_kn, n_k, u_t, x_n, nrep=nrep, key=jax.random.key(7), rep_chunk=rep_chunk)
    keys = jax.random.split(jax.random.key(7), nrep + (-nrep % rep_chunk))[:nrep]
    counts = tt(np.stack([np.asarray(jpoisson1_freq(k, (u_kn.shape[1],), dtype=np.float64)) for k in keys]))
    assert bool((counts == 0).any())  # some samples are dropped in every replicate
    sizes = [800] * 3
    out = torch.cat([tm._bootstrap_from_counts(tt(u_kn), sizes, tt(u_t), tt(x_n), c) for c in counts.split(6)])
    assert_close(out.mean(dim=0), mj, 1e-9)
    assert_close(out.std(dim=0, correction=1), sj, 1e-9)
    alone = torch.cat([tm._bootstrap_from_counts(tt(u_kn), sizes, tt(u_t), tt(x_n), counts[i : i + 1]) for i in range(nrep)])
    assert_close(out, alone, 1e-12)


def test_bootstrap_draws_from_its_generator():
    """Counts come from the explicit generator, one draw of N per replicate:
    the same seed gives the same numbers whatever ``rep_chunk``, another
    seed other numbers."""
    u_kn, n_k, xs, _ = _harmonic_problem([1.0, 2.0], 400, seed=44)
    u_t = xs[None, :] ** 2 / 2.0 / 1.3**2
    x_n = xs[:, None] ** 2
    a = tm.mbar_bootstrap_expectations(u_kn, n_k, u_t, x_n, nrep=10, rng=3, rep_chunk=3)
    b = tm.mbar_bootstrap_expectations(u_kn, n_k, u_t, x_n, nrep=10, rng=torch.Generator().manual_seed(3), rep_chunk=10)
    c = tm.mbar_bootstrap_expectations(u_kn, n_k, u_t, x_n, nrep=10, rng=4, rep_chunk=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert a[0].shape == (1, 1) and float(a[1][0, 0]) > 0


def test_mbar_model_matches_jax():
    tstates, jstates = _ig_states([0.8, 1.0, 1.3], (1500, 10), both=True)
    model, jmodel = MBARModel(tstates), JMBARModel(jstates)
    alphas = np.array([0.85, 1.1, 1.25])
    got = model.predict(alphas)
    assert got.shape == (3, 1)
    assert_close(got, jmodel.predict(alphas), RTOL)
    assert_close(model.predict(1.1), jmodel.predict(1.1), RTOL)
    assert model.predict(1.1).shape == (1,)
    assert_close(model.predict(alphas, method="sci"), got, 1e-9)
    mean, std = model.predict_ci(alphas, nrep=16, seed=2)
    assert mean.shape == std.shape == (3, 1) and bool((std > 0).all())
    assert bool(((mean - got).abs() < 4 * std).all())
    m1, s1 = model.predict_ci(1.1, nrep=16, seed=2)
    assert m1.shape == (1,)
    assert_close((m1, s1), (mean[1], std[1]), 1e-12)
    # (the bootstrap is held to the reference through its counts core above)


def test_mbar_model_matches_the_benchmark_reference():
    """``MBARModel.predict`` on the benchmark's harmonic problem
    (``portbench/configs/mbar_harmonic4.json``: K = 4 states, sigma in [1,
    3], 256 targets) at a tiny size, against the benchmark's plain reference
    (``portbench/reference/mbar_harmonic.py``: the self-consistent iteration
    to max |Δf| <= 1e-10, then an online log-sum-exp over sample blocks).
    Both in float64; the tolerance, 1e-9 on <x> and <x^2> (which run 1 to
    9), is the reference's stop: its iteration contracts about fivefold a
    step here, so its f_k sit within ~3e-11 of the fixed point the port's
    hybrid reaches at residual 1e-12 (the two agree to ~2e-11)."""
    from portbench.reference import mbar_harmonic as ref

    cfg = {"states": 4, "sigma_range": [1.0, 3.0]}
    sig = ref.sigmas(1.0, 3.0, 4)
    x = torch.randn((4, 2000), generator=torch.Generator().manual_seed(45), dtype=torch.float64) * sig[:, None]
    states = [
        tbeta.factory_extrapmodel(float(s) ** -2, tx.DataValues.from_vals(torch.stack([xk, xk * xk], -1), 0.5 * xk * xk, order=0), order=0)
        for s, xk in zip(sig, x)
    ]
    alphas = (ref.sigmas(1.0, 3.0, 256) ** -2).numpy()
    got = MBARModel(states).predict(alphas)
    want = ref.predict(cfg, {"x": x}, alphas)
    assert got.shape == want["pred"].shape == (256, 2)
    np.testing.assert_allclose(npy(got), npy(want["pred"]), rtol=0, atol=1e-9)
    assert float((want["pred"][:, 1] - torch.as_tensor(1 / alphas)).abs().max()) < 0.5  # <x^2> = sigma_a^2, to sampling error

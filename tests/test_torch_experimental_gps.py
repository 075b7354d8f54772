"""The torch port's experimental noise-GP models
(``thermoextrap_tpu_torch.gpr_active.experimental``) against exact numpy
float64 oracles and the JAX package: the port's mirror of
tests/test_experimental_gps.py, with the same oracles and bars, plus the
LML and predictions of both packages at the same parameters within 1e-10
relative (1e-10 of the largest entry for the variances).
"""

import math

import numpy as np
import pytest
import torch
from _torch_parity import npy
from scipy.linalg import cho_solve, cholesky, solve_triangular

from thermoextrap_tpu.gpr_active import experimental as jexp
from thermoextrap_tpu_torch.gpr_active import gp_models
from thermoextrap_tpu_torch.gpr_active.experimental import (
    _JITTER,
    FullyHeteroscedasticGPR,
    HetGaussianNoiseGP,
    PlainGPR,
    StationaryKernel,
)

RNG = np.random.default_rng(1234)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


def oracle_kernel(kind, x1, x2, var, ls):
    d = (x1[:, None, :] - x2[None, :, :]) / np.asarray(ls)
    r2 = (d**2).sum(-1)
    if kind == "rbf":
        return var * np.exp(-0.5 * r2)
    r = np.sqrt(r2)
    s5 = math.sqrt(5.0)
    return var * (1.0 + s5 * r + 5.0 * r2 / 3.0) * np.exp(-s5 * r)


def oracle_mvn_ld(y, mu, chol_lower):
    a = solve_triangular(chol_lower, y - mu, lower=True)
    n, d = y.shape
    return -0.5 * (a**2).sum() - 0.5 * n * d * math.log(2.0 * math.pi) - d * np.log(np.diag(chol_lower)).sum()


def oracle_gauss_ld(x, mu, var):
    return -0.5 * (math.log(2.0 * math.pi) + np.log(var) + (x - mu) ** 2 / var)


def oracle_gpr(x, y, xnew, kind, var, ls, sigma2):
    """Zero-mean exact GPR: (lml, posterior mean, posterior diag var)."""
    k = oracle_kernel(kind, x, x, var, ls)
    L = cholesky(k + (sigma2 + _JITTER) * np.eye(len(x)), lower=True)
    lml = oracle_mvn_ld(y, 0.0, L)
    kmn = oracle_kernel(kind, x, xnew, var, ls)
    a = solve_triangular(L, kmn, lower=True)
    b = solve_triangular(L, y, lower=True)
    mean = a.T @ b
    vdiag = np.diag(oracle_kernel(kind, xnew, xnew, var, ls)) - (a**2).sum(0)
    return lml, mean, vdiag[:, None]


def make_het_data(n=14, d=1):
    """Synthetic heteroscedastic dataset in the reference's 3-column layout."""
    x = np.sort(RNG.uniform(0.0, 3.0, size=(n, d)), axis=0)
    true_noise = 0.05 + 0.4 * np.sin(0.8 * x[:, :1]) ** 2  # per-config variance
    nsamp = RNG.integers(50, 200, size=(n, 1)).astype(float)
    f = np.cos(1.3 * x[:, :1])
    yval = f + RNG.normal(size=(n, 1)) * np.sqrt(true_noise / nsamp)
    yvar = (true_noise / nsamp) * RNG.uniform(0.8, 1.25, size=(n, 1))
    return x, np.concatenate([yval, yvar, nsamp], axis=1), true_noise


def _close_to_jax(got, ref, rtol=1e-10):
    """Port outputs against the JAX package's: relative to the largest entry."""
    g, r = npy(got), np.asarray(ref)
    assert g.shape == r.shape
    assert np.max(np.abs(g - r)) <= rtol * max(np.max(np.abs(r)), 1e-300)


# ---------------------------------------------------------------------------
# stationary kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("dims", [1, 3])
def test_stationary_kernel_matches_oracle(kind, dims):
    ls = RNG.uniform(0.5, 2.0, size=dims)
    kern = StationaryKernel(dims, kind, variance=1.7, lengthscales=ls)
    x1 = RNG.normal(size=(9, dims))
    x2 = RNG.normal(size=(7, dims))
    got = kern(x1, x2)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(npy(got), oracle_kernel(kind, x1, x2, 1.7, ls), rtol=1e-10, atol=1e-12)
    k11 = npy(kern(x1))
    np.testing.assert_allclose(k11, k11.T, rtol=1e-12)
    np.testing.assert_allclose(np.diag(k11), 1.7, rtol=1e-9)
    jk = jexp.StationaryKernel(dims, kind, variance=1.7, lengthscales=ls)
    _close_to_jax(got, jk(x1, x2))
    assert kern.param_names == jk.param_names


def test_stationary_kernel_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        StationaryKernel(1, "cauchy")


# ---------------------------------------------------------------------------
# PlainGPR (the inner noise model)
# ---------------------------------------------------------------------------


class TestPlainGPR:
    def setup_method(self):
        self.x = np.linspace(0.0, 2.0, 11)[:, None]
        self.y = np.sin(2.0 * self.x) + 0.05 * RNG.normal(size=(11, 1))
        self.kern = StationaryKernel(1, "matern52", variance=1.3, lengthscales=0.8)
        self.gp = PlainGPR((self.x, self.y), self.kern, noise_variance=0.04)

    def test_lml_matches_oracle(self):
        lml, _, _ = oracle_gpr(self.x, self.y, self.x, "matern52", 1.3, 0.8, 0.04)
        np.testing.assert_allclose(float(self.gp.log_marginal_likelihood()), lml, rtol=1e-9)

    def test_predict_matches_oracle(self):
        xnew = np.linspace(-0.3, 2.3, 17)[:, None]
        _, mean, vdiag = oracle_gpr(self.x, self.y, xnew, "matern52", 1.3, 0.8, 0.04)
        m, v = self.gp.predict_f(xnew)
        np.testing.assert_allclose(npy(m), mean, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(npy(v), vdiag, rtol=1e-7, atol=1e-10)
        m2, vfull = self.gp.predict_f(xnew, full_cov=True)
        np.testing.assert_allclose(npy(m2), mean, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.diag(npy(vfull))[:, None], vdiag, rtol=1e-7, atol=1e-10)

    def test_train_improves_and_roundtrips(self, tmp_path):
        neg0 = float(self.gp.neg_lml(self.gp.get_unconstrained()))
        self.gp.train(max_iter=60)
        neg1 = float(self.gp.neg_lml(self.gp.get_unconstrained()))
        assert neg1 <= neg0 + 1e-9
        p = self.gp.parameters()
        assert all(np.isfinite(v) and v > 0 for v in p.values())
        self.gp.save_params(tmp_path / "p.json")
        self.gp.set_parameters({k: v * 2.0 for k, v in p.items()})
        self.gp.load_params(tmp_path / "p.json")
        assert self.gp.parameters() == pytest.approx(p)

    def test_matches_jax_at_the_same_parameters(self):
        """The LML, its gradient and both posteriors at the trained port's
        parameters, and the two packages' trained NLL (rtol 1e-6)."""
        self.gp.train(max_iter=60)
        jgp = jexp.PlainGPR((self.x, self.y), jexp.StationaryKernel(1, "matern52", variance=1.3, lengthscales=0.8), noise_variance=0.04)
        jres = jgp.train(max_iter=60)
        assert float(self.gp.neg_lml(self.gp.get_unconstrained())) == pytest.approx(float(jres.fun), rel=1e-6)
        jgp.set_parameters(self.gp.parameters())
        vec = self.gp.get_unconstrained()
        val, grad = self.gp._lml_fns()["neg_vag"](vec, *self.gp._bound_args())
        jval, jgrad = jgp._lml_fns()["neg_vag"](np.asarray(vec), *jgp._bound_args())
        assert float(val) == pytest.approx(float(jval), rel=1e-10)
        assert np.max(np.abs(npy(grad) - np.asarray(jgrad))) <= 1e-10 * max(np.max(np.abs(np.asarray(jgrad))), abs(float(jval)))
        xnew = np.linspace(-0.3, 2.3, 17)[:, None]
        for full_cov in (False, True):
            for g, r in zip(self.gp.predict_f(xnew, full_cov=full_cov), jgp.predict_f(xnew, full_cov=full_cov)):
                _close_to_jax(g, r)


# ---------------------------------------------------------------------------
# HetGaussianNoiseGP likelihood formulas
# ---------------------------------------------------------------------------


class TestHetGaussianNoiseGP:
    def setup_method(self):
        self.x = np.linspace(0.0, 1.0, 8)[:, None]
        self.z = RNG.normal(size=(8, 1))
        self.lik = HetGaussianNoiseGP((self.x, self.z))
        self.lik.noise_gp.likelihood_variance.value = 0.07
        self.F = np.stack([RNG.normal(size=6), RNG.uniform(0.1, 0.5, size=6)], axis=1)
        self.Fvar = RNG.uniform(0.01, 0.1, size=(6, 2))
        self.Y = np.stack([RNG.normal(size=6), RNG.uniform(0.05, 0.6, size=6)], axis=1)
        self.jlik = jexp.HetGaussianNoiseGP((self.x, self.z))
        self.jlik.noise_gp.likelihood_variance.value = 0.07

    def test_default_inner_kernel_is_matern52(self):
        assert self.lik.noise_gp.kernel.kind == "matern52"

    def test_scalar_log_prob(self):
        got = self.lik.scalar_log_prob(self.F, self.Y)
        want = oracle_gauss_ld(self.Y[:, :1], self.F[:, :1], self.F[:, 1:]) + oracle_gauss_ld(
            np.log(self.Y[:, 1:]), np.log(self.F[:, 1:]), 0.07
        )
        np.testing.assert_allclose(npy(got), want, rtol=1e-12)
        _close_to_jax(got, self.jlik.scalar_log_prob(self.F, self.Y))

    def test_conditional_moments(self):
        np.testing.assert_allclose(npy(self.lik.conditional_mean(self.F)), self.F[:, :1])
        np.testing.assert_allclose(npy(self.lik.conditional_variance(self.F)), self.F[:, 1:])

    def test_predict_mean_and_var(self):
        m, v = self.lik.predict_mean_and_var(self.F, self.Fvar)
        np.testing.assert_allclose(npy(m), self.F[:, :1])
        np.testing.assert_allclose(npy(v), self.Fvar[:, :1] + self.F[:, 1:], rtol=1e-12)

    def test_predict_log_density(self):
        got = self.lik.predict_log_density(self.F, self.Fvar, self.Y)
        want = oracle_gauss_ld(self.Y[:, :1], self.F[:, :1], self.Fvar[:, :1] + self.F[:, 1:]).sum(-1) + oracle_gauss_ld(
            np.log(self.Y[:, 1:]), np.log(self.F[:, 1:]), self.Fvar[:, 1:]
        ).sum(-1)
        np.testing.assert_allclose(npy(got), want, rtol=1e-12)
        _close_to_jax(got, self.jlik.predict_log_density(self.F, self.Fvar, self.Y))

    def test_variational_expectations(self):
        got = self.lik.variational_expectations(self.F, self.Fvar, self.Y)
        l2p = math.log(2.0 * math.pi)
        want = (
            -0.5 * l2p - 0.5 * np.log(self.F[:, 1:]) - 0.5 * ((self.Y[:, :1] - self.F[:, :1]) ** 2 + self.Fvar[:, :1]) / self.F[:, 1:]
        ).sum(-1) + (
            -0.5 * l2p - 0.5 * math.log(0.07) - 0.5 * ((self.Y[:, 1:] - np.log(self.F[:, 1:])) ** 2 + self.Fvar[:, 1:]) / 0.07
        ).sum(-1)
        np.testing.assert_allclose(npy(got), want, rtol=1e-12)
        _close_to_jax(got, self.jlik.variational_expectations(self.F, self.Fvar, self.Y))


# ---------------------------------------------------------------------------
# FullyHeteroscedasticGPR
# ---------------------------------------------------------------------------


class TestFullyHeteroscedasticGPR:
    def setup_method(self):
        self.x, self.y3, self.true_noise = make_het_data()
        self.model = self._model(StationaryKernel)

    def _model(self, kernel_cls, mean_function=None, cls=FullyHeteroscedasticGPR):
        model = cls(
            (self.x, self.y3),
            kernel_cls(1, "rbf", variance=1.1, lengthscales=0.9),
            mean_function=mean_function,
            noise_kernel=kernel_cls(1, "matern52", variance=0.8, lengthscales=1.2),
        )
        model.likelihood.noise_gp.likelihood_variance.value = 0.15
        return model

    def _oracle_pieces(self):
        x, y3 = self.x, self.y3
        z = np.log(y3[:, 1:2] * y3[:, 2:3])
        n = y3[:, -1]
        kn = oracle_kernel("matern52", x, x, 0.8, 1.2)
        Ln = cholesky(kn + (0.15 + _JITTER) * np.eye(len(x)), lower=True)
        lml_inner = oracle_mvn_ld(z, 0.0, Ln)
        log_s = kn @ cho_solve((Ln, True), z)
        s_diag = np.exp(log_s[:, 0]) / n
        k = oracle_kernel("rbf", x, x, 1.1, 0.9)
        L = cholesky(k + np.diag(s_diag + _JITTER), lower=True)
        lml_outer = oracle_mvn_ld(y3[:, :1], 0.0, L)
        return z, n, s_diag, L, Ln, lml_outer, lml_inner

    def test_rejects_bad_y_shape(self):
        with pytest.raises(ValueError, match="N, 3"):
            FullyHeteroscedasticGPR((self.x, self.y3[:, :2]), StationaryKernel(1, "rbf"))
        with pytest.raises(ValueError, match="N, 3"):
            self.model.predict_log_density((self.x, self.y3[:, :2]))

    def test_joint_lml_matches_oracle(self):
        *_, lml_outer, lml_inner = self._oracle_pieces()
        np.testing.assert_allclose(float(self.model.log_marginal_likelihood()), lml_outer + lml_inner, rtol=1e-9)
        np.testing.assert_allclose(float(self.model.maximum_log_likelihood_objective()), lml_outer + lml_inner, rtol=1e-9)

    def test_predict_noise_matches_oracle(self):
        z, *_ = self._oracle_pieces()
        xnew = np.linspace(0.2, 2.8, 9)[:, None]
        _, mean, vdiag = oracle_gpr(self.x, z, xnew, "matern52", 0.8, 1.2, 0.15)
        noise, logvar = self.model.predict_noise(xnew)
        np.testing.assert_allclose(npy(noise), np.exp(mean), rtol=1e-8)
        np.testing.assert_allclose(npy(logvar), vdiag, rtol=1e-7, atol=1e-10)

    def test_predict_f_matches_oracle(self):
        _, _, s_diag, L, *_ = self._oracle_pieces()
        xnew = np.linspace(0.0, 3.0, 13)[:, None]
        kmn = oracle_kernel("rbf", self.x, xnew, 1.1, 0.9)
        a = solve_triangular(L, kmn, lower=True)
        b = solve_triangular(L, self.y3[:, :1], lower=True)
        mean = a.T @ b
        vdiag = np.diag(oracle_kernel("rbf", xnew, xnew, 1.1, 0.9)) - (a**2).sum(0)
        m, v = self.model.predict_f(xnew)
        np.testing.assert_allclose(npy(m), mean, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(npy(v), vdiag[:, None], rtol=1e-7, atol=1e-10)
        m2, vfull = self.model.predict_f(xnew, full_cov=True)
        np.testing.assert_allclose(npy(m2), mean, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(np.diag(npy(vfull)), vdiag, rtol=1e-7, atol=1e-10)

    def test_predict_y_composition(self):
        xnew = np.linspace(0.5, 2.5, 5)[:, None]
        f_mean, f_var = self.model.predict_f(xnew)
        noise, _ = self.model.predict_noise(xnew)
        m, v = self.model.predict_y(xnew)
        np.testing.assert_allclose(npy(m), npy(f_mean), rtol=1e-12)
        np.testing.assert_allclose(npy(v), npy(f_var) + npy(noise) / self.model.min_samps, rtol=1e-10)

    def test_predict_log_density_is_finite_and_oracle_consistent(self):
        ld = npy(self.model.predict_log_density((self.x, self.y3)))
        assert ld.shape == (len(self.x),)
        assert np.all(np.isfinite(ld))
        f_mean, f_var = (npy(a) for a in self.model.predict_f(self.x))
        noise, noise_var = (npy(a) for a in self.model.predict_noise(self.x))
        yobs = self.y3[:, 1:2] * self.y3[:, 2:3]
        want = oracle_gauss_ld(self.y3[:, :1], f_mean, f_var + noise).sum(-1) + oracle_gauss_ld(np.log(yobs), np.log(noise), noise_var).sum(-1)
        np.testing.assert_allclose(ld, want, rtol=1e-9)

    def test_joint_training_improves_and_learns_noise_field(self):
        neg0 = float(self.model.neg_lml(self.model.get_unconstrained()))
        self.model.train(max_iter=120)
        neg1 = float(self.model.neg_lml(self.model.get_unconstrained()))
        assert neg1 <= neg0 + 1e-9
        assert all(np.isfinite(v) for v in self.model.parameters().values())
        noise, _ = self.model.predict_noise(self.x)
        c = np.corrcoef(np.log(npy(noise)[:, 0]), np.log(self.true_noise[:, 0]))
        assert c[0, 1] > 0.5

    def test_mean_function_is_applied(self):
        def const(X):
            return np.full((np.asarray(X).shape[0], 1), 2.5)

        m = self._model(StationaryKernel, mean_function=const)
        mean, _ = m.predict_f(np.array([[40.0]]))  # far from data: posterior falls back to mean
        np.testing.assert_allclose(float(mean[0, 0]), 2.5, atol=1e-6)

    def test_matches_jax_at_the_same_parameters(self):
        """The joint LML and its gradient, ``predict_f`` (both forms),
        ``predict_noise``, ``predict_y`` and ``predict_log_density`` of both
        packages at the port's trained parameters; the two fits' NLL."""

        def const(X):
            return 0.3 * np.asarray(X)[:, :1]

        self.model = self._model(StationaryKernel, mean_function=const)
        jmodel = self._model(jexp.StationaryKernel, mean_function=const, cls=jexp.FullyHeteroscedasticGPR)
        res = self.model.train(max_iter=120)
        jres = jmodel.train(max_iter=120)
        assert float(res.fun) == pytest.approx(float(jres.fun), rel=1e-6)
        jmodel.set_parameters(self.model.parameters())
        vec = self.model.get_unconstrained()
        val, grad = self.model._lml_fns()["neg_vag"](vec, *self.model._bound_args())
        jval, jgrad = jmodel._lml_fns()["neg_vag"](np.asarray(vec), *jmodel._bound_args())
        assert float(val) == pytest.approx(float(jval), rel=1e-10)
        assert np.max(np.abs(npy(grad) - np.asarray(jgrad))) <= 1e-10 * max(np.max(np.abs(np.asarray(jgrad))), abs(float(jval)))
        xnew = np.linspace(0.0, 3.0, 13)[:, None]
        for full_cov in (False, True):
            for g, r in zip(self.model.predict_f(xnew, full_cov=full_cov), jmodel.predict_f(xnew, full_cov=full_cov)):
                _close_to_jax(g, r)
        for g, r in zip(
            (*self.model.predict_noise(xnew), *self.model.predict_y(xnew), self.model.predict_log_density((self.x, self.y3))),
            (*jmodel.predict_noise(xnew), *jmodel.predict_y(xnew), jmodel.predict_log_density((self.x, self.y3))),
        ):
            _close_to_jax(g, r)


def test_reference_names_resolve_through_gp_models():
    """``gp_models`` resolves the two noise-GP names from ``experimental``,
    as the JAX package does."""
    assert gp_models.HetGaussianNoiseGP is HetGaussianNoiseGP
    assert gp_models.FullyHeteroscedasticGPR is FullyHeteroscedasticGPR
    with pytest.raises(AttributeError):
        gp_models.NoSuchModel  # noqa: B018

"""The torch port's frozen GPR predictor (``gpr_active.serving``) against
``predict_f`` and the JAX package: the port's mirror of
tests/test_gpr_serving.py:63-259, with its bars (float64 serving equal to
``predict_f`` to 1e-10 / 1e-7 relative; float32 serving within 3e-4 relative
on the mean and 5e-6 k(x, x) on the variance), and the port's float64
predictor against the JAX package's at the same parameters.

The sharded queries (:228) are in ``tests/test_torch_parallel.py``, on a
world of 4 gloo ranks.  Left out: ``export_gpr_predictor`` (:269), which
waits for the port's ``serving_export``, and the refusal of float64 without
x64 (:246): torch has float64 everywhere, so the port accepts it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch
from _torch_parity import npy

from thermoextrap_tpu.gpr_active import gp_models as jgm
from thermoextrap_tpu.gpr_active import kernels as jkern
from thermoextrap_tpu.gpr_active import serving as jserving
from thermoextrap_tpu_torch.gpr_active.gp_models import (
    ConstantMeanWithDerivs,
    DerivativeKernel,
    HeteroscedasticGPR,
    HeteroscedasticGPRAnalyticalScale,
    LinearWithDerivs,
    SympyMeanFunc,
)
from thermoextrap_tpu_torch.gpr_active.kernels import CallableDerivativeKernel, RBFDerivKernel, make_rbf_expr
from thermoextrap_tpu_torch.gpr_active.serving import FrozenGPRPredictor, freeze_predictor


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sine_data(out_dim: int = 1):
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 2 * np.pi, 8)
    y0 = np.sin(xs) + rng.normal(0, 0.02, xs.shape)
    y1 = np.cos(xs) + rng.normal(0, 0.05, xs.shape)
    X = np.concatenate([np.stack([xs, np.zeros_like(xs)], 1), np.stack([xs, np.ones_like(xs)], 1)])
    Y = np.concatenate([y0, y1])[:, None]
    if out_dim == 2:
        Y = np.concatenate([Y, 2.0 * Y + 1.0], axis=1)
    cov = np.diag(np.concatenate([np.full_like(xs, 4e-4), np.full_like(xs, 2.5e-3)]))
    return X, Y, cov


@pytest.fixture(scope="module")
def trained():
    X, Y, cov = _sine_data()
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    model.train()
    return model


XT = np.linspace(0.5, 5.5, 11)


def _rows(order=0):
    return np.stack([XT, np.full_like(XT, order)], 1)


def _assert_f64(pred, model, order=0, mean_rtol=1e-9):
    mean_ref, var_ref = (npy(a) for a in model.predict_f(_rows(order)))
    mean, var = (npy(a) for a in pred(XT))
    assert mean.dtype == np.float64
    np.testing.assert_allclose(mean, mean_ref, rtol=mean_rtol, atol=1e-12)
    np.testing.assert_allclose(var, var_ref, rtol=1e-7, atol=1e-12)


class TestFreezePredictor:
    def test_f64_exact_vs_predict_f(self, trained):
        pred = freeze_predictor(trained, dtype=torch.float64)
        assert isinstance(pred, FrozenGPRPredictor) and pred.meta["dtype"] == "float64"
        _assert_f64(pred, trained, mean_rtol=1e-10)

    def test_f32_serving_accuracy(self, trained):
        mean_ref, var_ref = (npy(a) for a in trained.predict_f(_rows()))
        pred = freeze_predictor(trained)  # default float32
        mean, var = (npy(a) for a in pred(XT))
        assert mean.dtype == np.float32
        np.testing.assert_allclose(mean, mean_ref, rtol=3e-4, atol=3e-5)
        kvar = float(trained.parameters()["kernel/var"])
        assert np.all(var >= 0.0)
        np.testing.assert_allclose(var, var_ref, atol=5e-6 * kvar, rtol=3e-3)

    def test_derivative_query_order(self, trained):
        _assert_f64(freeze_predictor(trained, d_new=(1,), dtype=torch.float64), trained, order=1)

    def test_analytic_scale_variant(self):
        X, Y, cov = _sine_data()
        model = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel(), mean_function=ConstantMeanWithDerivs(Y, x_dim=1))
        model.train()
        pred = freeze_predictor(model, dtype=torch.float64)
        assert pred.meta["analytic_scale"]
        _assert_f64(pred, model)

    def test_multioutput_scale_fac(self):
        X, Y, cov = _sine_data(out_dim=2)
        model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), scale_fac=[1.0, 10.0])
        pred = freeze_predictor(model, dtype=torch.float64)
        assert tuple(pred(XT)[0].shape) == (len(XT), 2)
        _assert_f64(pred, model)

    @pytest.mark.parametrize("d_new", [(0,), (1,)])
    def test_linear_mean_function(self, d_new):
        X, Y, cov = _sine_data()
        x0, y0 = X[X[:, 1] == 0.0, :1], Y[X[:, 1] == 0.0]
        model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), mean_function=LinearWithDerivs(x0, y0))
        _assert_f64(freeze_predictor(model, d_new=d_new, dtype=torch.float64), model, order=d_new[0])

    def test_sympy_mean_function(self):
        X, Y, cov = _sine_data()
        x0, y0 = X[X[:, 1] == 0.0, :1], Y[X[:, 1] == 0.0]
        x, a, b = sp.symbols("x a b")
        model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), mean_function=SympyMeanFunc(a * sp.sin(x) + b, x0, y0))
        _assert_f64(freeze_predictor(model, dtype=torch.float64), model)

    def test_custom_mean_requires_override(self):
        class Weird:
            def __call__(self, X):
                return np.zeros((np.asarray(X).shape[0], 1))

        X, Y, cov = _sine_data()
        model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), mean_function=Weird())
        with pytest.raises(TypeError, match="mean_new_fn"):
            freeze_predictor(model)
        pred = freeze_predictor(model, dtype=torch.float64, mean_new_fn=lambda locs: torch.zeros((locs.shape[0], 1), dtype=locs.dtype))
        mean, _ = pred(XT)
        assert np.all(np.isfinite(npy(mean)))

    def test_callable_kernel_freezes(self):
        """Nested-``torch.func.grad`` kernels freeze too."""

        def rbf(x1, x2, var, ell):
            return var * torch.exp(-0.5 * ((x1[0] - x2[0]) / ell) ** 2)

        xs = np.linspace(0, 3, 6)
        X = np.stack([xs, np.zeros_like(xs)], axis=1)
        model = HeteroscedasticGPR(
            (X, np.sin(xs)[:, None], np.eye(6) * 1e-4), kernel=CallableDerivativeKernel(rbf, kernel_params={"var": 1.0, "l": 1.0})
        )
        _assert_f64(freeze_predictor(model, dtype=torch.float64), model)

    def test_multidim_observable(self):
        """obs_dims=2: the frozen 2-D kernel block and a mixed query order
        match predict_f at float64."""
        rng = np.random.default_rng(3)
        expr, params = make_rbf_expr(2)
        kern = DerivativeKernel(expr, 2, kernel_params=params)
        locs = rng.uniform(0, 2, (6, 2))
        X = np.concatenate(
            [np.concatenate([locs, np.zeros_like(locs)], axis=1), np.concatenate([locs, np.tile([[1.0, 0.0]], (6, 1))], axis=1)]
        )
        model = HeteroscedasticGPR((X, rng.normal(size=(12, 1)), np.diag(np.full(12, 1e-3))), kernel=kern)
        qt = rng.uniform(0, 2, (9, 2))
        for d_new in [(0, 0), (1, 0)]:
            mean_ref, var_ref = (npy(a) for a in model.predict_f(np.concatenate([qt, np.tile([d_new], (9, 1))], axis=1)))
            mean, var = (npy(a) for a in freeze_predictor(model, d_new=d_new, dtype=torch.float64)(qt))
            np.testing.assert_allclose(mean, mean_ref, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(var, var_ref, rtol=1e-7, atol=1e-12)

    def test_input_validation(self, trained):
        pred = freeze_predictor(trained)
        with pytest.raises(ValueError, match=r"locs must be \(M, 1\)"):
            pred(np.zeros((3, 2)))
        with pytest.raises(ValueError, match="d_new must have 1"):
            freeze_predictor(trained, d_new=(0, 0))
        with pytest.raises(TypeError, match="HeteroscedasticGPR"):
            freeze_predictor(object())
        with pytest.raises(ValueError, match="dtype"):
            freeze_predictor(trained, dtype=torch.float16)

    def test_tensor_queries_and_predict_fn(self, trained):
        """A tensor query (any float dtype) is cast to the serving dtype;
        ``predict_fn`` takes it directly."""
        pred = freeze_predictor(trained)
        got = pred(torch.tensor(XT, dtype=torch.float64))
        direct = pred.predict_fn(torch.tensor(XT, dtype=torch.float32)[:, None])
        assert got[0].dtype == torch.float32
        for g, d in zip(got, direct):
            assert torch.equal(g, d)


@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("d_new", [(0,), (1,)])
def test_frozen_float64_matches_jax(analytic, d_new):
    """Both packages' float64 predictors at the same parameters and mean."""
    X, Y, cov = _sine_data()
    x0, y0 = X[X[:, 1] == 0.0, :1], Y[X[:, 1] == 0.0]
    if analytic:
        jmodel = jgm.HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=jkern.RBFDerivKernel(), mean_function=jgm.LinearWithDerivs(x0, y0))
        model = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel(), mean_function=LinearWithDerivs(x0, y0))
    else:
        jmodel = jgm.HeteroscedasticGPR((X, Y, cov), kernel=jkern.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
        model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    jmodel.train()
    model.set_parameters(jmodel.parameters())
    got = freeze_predictor(model, d_new=d_new, dtype=torch.float64)(XT)
    ref = jserving.freeze_predictor(jmodel, d_new=d_new, dtype=jnp.float64)(XT)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.max(np.abs(npy(g) - r)) <= 1e-10 * np.max(np.abs(r))

"""The derivative-GPR core of the torch port (``gpr_active.gp_models`` and
``gpr_active.kernels``) against the JAX package, and the port's mirror of
tests/test_gps.py.

Parity: the same numpy inputs go through both packages, all in float64 on
the CPU.  Kernel matrices agree to 1e-10 of their largest entry (the bar of
tests/test_gps.py:71-87; the port's RBF is the closed Hermite form, the
JAX package's a lambdified sympy derivative).  The LML, the log-whitened LML,
their gradients and ``predict_f`` agree to 1e-8 of their largest entry, the
variances taken against the prior variance ``var`` (the JAX suite's bar for
the GP's linear algebra, tests/test_gps.py:292-309 and :386-397).  A
training run from the same start reaches the same NLL to 1e-6 relative, and
the two posteriors' means agree to 1e-3 of their posterior sigma: two
LAPACK call sequences may send L-BFGS-B down slightly different paths, so
the parameters themselves are not held to a bar.

torch's CPU thread pool costs more than these 16-row factorizations, so the
module runs torch on one thread (restored afterwards).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch
from _torch_parity import npy
from scipy import stats

from thermoextrap_tpu.gpr_active import gp_models as jgm
from thermoextrap_tpu.gpr_active import kernels as jkern
from thermoextrap_tpu_torch.gpr_active import gp_models as gm
from thermoextrap_tpu_torch.gpr_active.gp_models import (
    ConstantMeanWithDerivs,
    DerivativeKernel,
    HetGaussianDeriv,
    HetGaussianSimple,
    HeteroscedasticGPR,
    HeteroscedasticGPRAnalyticalScale,
    LinearWithDerivs,
    SympyMeanFunc,
    multioutput_multivariate_normal,
    predict_f_batched,
)
from thermoextrap_tpu_torch.gpr_active.kernels import (
    CallableDerivativeKernel,
    ChangeInnerOuterRBFDerivKernel,
    RBFDerivKernel,
    make_matern_expr,
    make_poly_expr,
    make_rbf_expr,
)

KERNEL_BAR = 1e-10
CORE_BAR = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_to_largest(got, ref, bar):
    got, ref = np.asarray(npy(got), dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(got - ref)))
    assert err <= bar * scale, (err, scale)


def _close_grad(got, ref, value):
    """A gradient to 1e-8 of the larger of its largest entry and the
    value's magnitude: at an optimum the gradient vanishes, and what remains
    is cancellation among terms of the value's size."""
    got, ref = np.asarray(npy(got), dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), abs(value))
    assert float(np.max(np.abs(got - ref))) <= CORE_BAR * scale


def fd_mixed_partial(f, x1, x2, d1, d2, h=1e-4):
    """Finite-difference mixed partial d^{d1}_{x1} d^{d2}_{x2} f."""
    if d1 == 0 and d2 == 0:
        return f(x1, x2)
    if d1 > 0:
        return (fd_mixed_partial(f, x1 + h, x2, d1 - 1, d2, h) - fd_mixed_partial(f, x1 - h, x2, d1 - 1, d2, h)) / (2 * h)
    return (fd_mixed_partial(f, x1, x2 + h, d1, d2 - 1, h) - fd_mixed_partial(f, x1, x2 - h, d1, d2 - 1, h)) / (2 * h)


def rbf_deriv_closed_form(x1, x2, d1, d2, var, ell):
    r"""Exact mixed partial of the RBF kernel (independent numpy oracle of
    tests/test_gps.py:42-63): ``var l^-(d1+d2) (-1)^d1 He_{d1+d2}(z) e^{-z^2/2}``."""
    z = (x1 - x2) / ell
    n = d1 + d2
    he_prev, he = 1.0, z
    if n == 0:
        he_n = he_prev
    elif n == 1:
        he_n = he
    else:
        for k in range(1, n):
            he_prev, he = he, z * he - k * he_prev
        he_n = he
    return var * ell ** (-n) * (-1.0) ** d1 * he_n * np.exp(-0.5 * z * z)


def _torch_rbf(x1, x2, var, ell):
    return var * torch.exp(-0.5 * ((x1[0] - x2[0]) / ell) ** 2)


def _jax_rbf(x1, x2, var, ell):
    return var * jnp.exp(-0.5 * ((x1[0] - x2[0]) / ell) ** 2)


def _sine_data(seed=0, n=8):
    """Noisy sine and derivative data (tests/test_gps.py:256-282)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 2.0 * np.pi, n)
    noise0, noise1 = 0.02, 0.05
    y0 = np.sin(xs) + rng.normal(0, noise0, xs.shape)
    y1 = np.cos(xs) + rng.normal(0, noise1, xs.shape)
    X = np.concatenate([np.stack([xs, np.zeros_like(xs)], axis=1), np.stack([xs, np.ones_like(xs)], axis=1)])
    Y = np.concatenate([y0, y1])[:, None]
    cov = np.diag(np.concatenate([np.full_like(xs, noise0**2), np.full_like(xs, noise1**2)]))
    return X, Y, cov


@pytest.fixture(scope="module")
def sine_fits():
    """The sine fit in both packages from the same start:
    ``(port model, port result, JAX model, JAX result)``."""
    X, Y, cov = _sine_data()
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    res = model.train()
    jmodel = jgm.HeteroscedasticGPR((X, Y, cov), kernel=jkern.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    jres = jmodel.train()
    return model, res, jmodel, jres


@pytest.fixture(scope="module")
def sine_fit(sine_fits):
    return sine_fits[0], sine_fits[1]


# -- parity: the kernels ---------------------------------------------------------------


def _orders_grid(locs, orders, obs=1):
    """Rows of every location at every order tuple."""
    rows = [np.concatenate([np.atleast_1d(x), np.asarray(o, dtype=float)]) for o in orders for x in locs]
    return np.asarray(rows, dtype=np.float64).reshape(-1, 2 * obs)


def _kernel_pair(name):
    """``(port kernel, JAX kernel, params, X)`` of one parity case."""
    locs = np.array([-0.7, -0.3, 0.1, 0.5, 1.2])
    orders = [(k,) for k in range(5)]
    if name == "rbf":
        return RBFDerivKernel(), jkern.RBFDerivKernel(), {"var": 1.7, "l": 0.9}, _orders_grid(locs, orders)
    if name == "change_inner_outer":
        # orders up to 2 x 2: the JAX package's sympy route takes ~70 s for
        # this kernel at 4 x 4 (test_change_inner_outer_far_from_switches
        # holds the port's to 4 x 4)
        params = {"c1": -0.4, "c2": 0.6, "l_in": 0.7, "l_out": 1.3, "s": 3.0, "var": 1.2}
        return ChangeInnerOuterRBFDerivKernel(), jkern.ChangeInnerOuterRBFDerivKernel(), params, _orders_grid(locs, orders[:3])
    if name == "callable":
        # against the JAX package's callable kernel at orders up to 2 x 2 (its
        # nested jax.grad runs eagerly, ~10 s at 4 x 4), and against its
        # sympy RBF at 4 x 4
        t = CallableDerivativeKernel(_torch_rbf, kernel_params={"var": 1.4, "l": 0.8})
        j = jkern.CallableDerivativeKernel(_jax_rbf, kernel_params={"var": 1.4, "l": 0.8})
        return t, j, {"var": 1.4, "l": 0.8}, _orders_grid(locs, orders[:3])
    pts = np.array([[0.0, 0.4], [0.5, 0.2], [0.1, 0.9], [1.0, -0.3]])
    orders2 = [(0, 0), (1, 0), (0, 2), (2, 1), (1, 3)]
    expr, params = make_rbf_expr(2)
    jexpr, jparams = jkern.make_rbf_expr(2)
    pvals = {"var": 1.3, "l_0": 0.8, "l_1": 1.6}
    return DerivativeKernel(expr, 2, params), jgm.DerivativeKernel(jexpr, 2, jparams), pvals, _orders_grid(pts, orders2, 2)


@pytest.mark.parametrize("name", ["rbf", "change_inner_outer", "callable", "multidim_rbf"])
def test_kernel_matches_jax(name):
    """K and K_diag against the JAX package, orders up to 4 x 4 (the
    multidim RBF: up to 4 in total per row), to 1e-10 of the largest entry."""
    kern, jkernel, params, X = _kernel_pair(name)
    assert list(kern.params) == list(jkernel.params)
    ref = np.asarray(jkernel.K(X, params=params))
    _close_to_largest(kern.K(X, params=params), ref, KERNEL_BAR)
    _close_to_largest(kern.K_diag(X, params=params), np.asarray(jkernel.K_diag(X, params=params)), KERNEL_BAR)
    if name == "callable":
        X = _orders_grid(np.array([-0.7, -0.3, 0.1, 0.5, 1.2]), [(k,) for k in range(5)])
        jkernel = jkern.RBFDerivKernel()
        _close_to_largest(kern.K(X, params=params), np.asarray(jkernel.K(X, params=params)), KERNEL_BAR)
        _close_to_largest(kern.K_diag(X, params=params), np.asarray(jkernel.K_diag(X, params=params)), KERNEL_BAR)
    if name == "rbf":
        # the per-pair functions of pair_table (the masked assembly) give the same matrix
        x, gid, groups = kern._rows(X, torch.device("cpu"))
        pvals = kern._param_values(params, torch.device("cpu"))
        masked = gm._pair_masked_matrix(x, gid, groups, x, gid, groups, pvals, kern.pair_table(groups, groups))
        _close_to_largest(masked, ref, KERNEL_BAR)
        # two row sets, and the kernel's own parameter values
        for k, spec in kern.params.items():
            spec.value = jkernel.params[k].value = float(params[k])
        _close_to_largest(kern.K(X[::2], X[1::3]), np.asarray(jkernel.K(X[::2], X[1::3])), KERNEL_BAR)


def test_change_inner_outer_far_from_switches():
    """Far inside ``(c1, c2)`` both tanh switches are flat to float64, so
    the changepoint kernel is the inner RBF: orders up to 4 x 4 against the
    closed form, to 1e-10 of the largest entry."""
    params = {"c1": -50.0, "c2": 50.0, "l_in": 0.7, "l_out": 1.3, "s": 3.0, "var": 1.2}
    X = _orders_grid(np.array([-0.7, -0.3, 0.1, 0.5, 1.2]), [(k,) for k in range(5)])
    ref = RBFDerivKernel().K(X, params={"var": 1.2, "l": 0.7})
    _close_to_largest(ChangeInnerOuterRBFDerivKernel().K(X, params=params), npy(ref), KERNEL_BAR)


@pytest.mark.parametrize("factory", ["matern", "poly"])
def test_distance_kernels_match_jax(factory):
    """Matern and the polynomial (p = 3) at the distinct locations and the
    order pairs of tests/test_gps.py:158-179 (|x1 - x2| kernels cannot be
    differentiated where the two points coincide)."""
    make, jmake = (make_matern_expr, jkern.make_matern_expr) if factory == "matern" else (make_poly_expr, jkern.make_poly_expr)
    expr, params = make(3)
    jexpr, jparams = jmake(3)
    kern, jkernel = DerivativeKernel(expr, 1, kernel_params=params), jgm.DerivativeKernel(jexpr, 1, kernel_params=jparams)
    xs1, xs2 = np.array([0.4, 0.9]), np.array([0.15, 0.7])
    params = {"l": 1.3, "var": 0.8}
    for d1, d2 in [(0, 0), (1, 0), (1, 1), (2, 1)]:
        X1 = np.stack([xs1, np.full_like(xs1, d1)], axis=1)
        X2 = np.stack([xs2, np.full_like(xs2, d2)], axis=1)
        _close_to_largest(kern.K(X1, X2, params=params), np.asarray(jkernel.K(X1, X2, params=params)), KERNEL_BAR)


def test_positive_transform_matches_jax():
    """``logaddexp(x, 0) + 1e-6`` and its inverse, where softplus would
    switch to the identity (x = 25) and at the inverse's switch (y = 30)."""
    raw = np.array([-40.0, -3.0, 0.0, 0.7, 19.0, 25.0, 31.0])
    for x in raw:
        got = float(gm.Parameter(0.0, "positive").constrain(torch.tensor(x)))
        assert got == pytest.approx(float(jgm._softplus(jnp.asarray(x))), rel=1e-15, abs=0.0)
    for y in (1e-6, 0.3, 2.0, 29.9, 30.5, 1e3):
        got = float(gm.Parameter(y, "positive").unconstrain())
        assert got == pytest.approx(float(jgm.Parameter(y, "positive").unconstrain()), rel=1e-15, abs=1e-15)


# -- parity: the LML core, the posterior, training ---------------------------------------


@pytest.mark.parametrize("which", ["optimum", "zeros", "0.7"])
def test_lml_core_matches_jax(sine_fits, which):
    """The LML, the log-whitened LML and both value-and-gradients at a
    fixed unconstrained vector, to 1e-8 of their largest entry."""
    model, _, jmodel, jres = sine_fits
    vec = {"optimum": jres.x, "zeros": np.zeros_like(jres.x), "0.7": np.full_like(jres.x, 0.7)}[which]
    fns, jfns = model._lml_fns(), jmodel._lml_fns()
    bound, jbound = model._bound_args(), jmodel._bound_args()
    tv = torch.as_tensor(vec)
    with jgm._compute_ctx():
        jv = jnp.asarray(vec, jnp.float64)
        for key in ("lml", "lml_logw"):
            _close_to_largest(fns[key](tv, *bound), np.asarray(jfns[key](jv, *jbound)), CORE_BAR)
        for key in ("neg_vag", "neg_vag_logw"):
            val, grad = fns[key](tv, *bound)
            jval, jgrad = jfns[key](jv, *jbound)
            _close_to_largest(val, np.asarray(jval), CORE_BAR)
            _close_grad(grad, np.asarray(jgrad), float(jval))


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_f_matches_jax(sine_fits, full_cov):
    """The posterior at the JAX optimum, orders 0 and 1: means to 1e-8 of
    the largest mean, variances to 1e-8 of ``var``."""
    jmodel = sine_fits[2]
    X, Y, cov = _sine_data()
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    model.set_parameters(jmodel.parameters())
    var = jmodel.parameters()["kernel/var"]
    xt = np.linspace(0.5, 5.5, 7)
    for order in (0, 1):
        Xt = np.stack([xt, np.full_like(xt, order)], axis=1)
        mean, cov = model.predict_f(Xt, full_cov=full_cov)
        jmean, jcov = jmodel.predict_f(Xt, full_cov=full_cov)
        _close_to_largest(mean, np.asarray(jmean), CORE_BAR)
        assert npy(cov).shape == np.asarray(jcov).shape
        assert np.max(np.abs(npy(cov) - np.asarray(jcov))) <= CORE_BAR * var


def test_train_matches_jax():
    """train() from the same start: the final NLL to 1e-6 relative, the two
    posterior means to 1e-3 of their posterior sigma."""
    X, Y, cov = _sine_data(seed=5)
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    jmodel = jgm.HeteroscedasticGPR((X, Y, cov), kernel=jkern.RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    np.testing.assert_allclose(npy(model.get_unconstrained()), np.asarray(jmodel.get_unconstrained()), rtol=1e-15)
    res, jres = model.train(), jmodel.train()
    assert res.fun == pytest.approx(float(jres.fun), rel=1e-6)
    assert float(model.neg_lml(model.get_unconstrained())) == pytest.approx(float(jres.fun), rel=1e-6)
    xt = np.linspace(0.3, 6.0, 13)
    for order in (0, 1):
        Xt = np.stack([xt, np.full_like(xt, order)], axis=1)
        mean, var = (npy(a) for a in model.predict_f(Xt))
        jmean, jvar = (np.asarray(a) for a in jmodel.predict_f(Xt))
        assert np.all(np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar))


def test_cholesky_guard_matches_jax():
    """Where K + S is not positive definite (a noise covariance of -1 and a
    small kernel variance), both LMLs are NaN, and training stays at its
    start with ``fun = 1e12`` and the same parameters in both packages."""
    X, Y, _ = _sine_data()
    cov = -np.eye(len(X))
    kw = {"likelihood_kwargs": {"p": 0.0, "constrain_p": True, "transform_p": "none"}}
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), **kw)
    jmodel = jgm.HeteroscedasticGPR((X, Y, cov), kernel=jkern.RBFDerivKernel(), **kw)
    vec = np.array([0.0, -30.0])  # l ~ 0.69, var ~ 1e-6
    val, grad = model._lml_fns()["neg_vag"](torch.as_tensor(vec), *model._bound_args())
    with jgm._compute_ctx():
        jval, _ = jmodel._lml_fns()["neg_vag"](jnp.asarray(vec), *jmodel._bound_args())
    assert np.isnan(float(val)) and np.isnan(float(jval))
    assert torch.isnan(model.log_marginal_likelihood(vec))
    ends = []
    for m in (model, jmodel):
        m.set_unconstrained(vec)
        x0 = np.asarray(m.get_unconstrained(), dtype=np.float64)
        res = m.train(max_iter=20)
        assert res.fun == 1e12
        np.testing.assert_array_equal(np.asarray(res.x), x0)
        ends.append(m.parameters())
    assert ends[0].keys() == ends[1].keys()
    for k in ends[0]:
        assert ends[0][k] == pytest.approx(ends[1][k], rel=1e-12)


def test_rollback_matches_jax():
    """An objective that turns non-finite after a few evaluations: both
    packages map it to 1e12 with a zero gradient, and both roll back to the
    starting parameters with ``res.fun`` the starting value."""
    X, Y, cov = _sine_data()
    runs = []
    for pkg, kern in ((gm, RBFDerivKernel), (jgm, jkern.RBFDerivKernel)):
        m = pkg.HeteroscedasticGPR((X, Y, cov), kernel=kern(), likelihood_kwargs={"p": 1.0})
        real = m._lml_fns()["neg_vag"]
        calls = []

        def flaky(x, *b, real=real, calls=calls):
            calls.append(1)
            v, g = real(x, *b)
            return (v * float("nan"), g) if len(calls) > 3 else (v, g)

        m._lml_fns = lambda flaky=flaky: {"neg_vag": flaky}
        start = m.parameters()
        x0 = np.asarray(m.get_unconstrained(), dtype=np.float64)
        res = m.train()
        assert m.parameters() == start
        np.testing.assert_array_equal(np.asarray(res.x), x0)
        runs.append(float(res.fun))
    assert runs[0] == pytest.approx(runs[1], rel=CORE_BAR)


# -- parity: the other models and pieces ----------------------------------------------------


def test_multioutput_mvn_matches_jax(rng_np):
    n, d = 6, 3
    x, mu = rng_np.normal(size=(n, d)), rng_np.normal(size=(n, d))
    a = rng_np.normal(size=(d, n, n))
    chol = np.linalg.cholesky(a @ a.transpose(0, 2, 1) + n * np.eye(n))
    with jgm._compute_ctx():
        ref = np.asarray(jgm.multioutput_multivariate_normal(x, mu, chol))
    np.testing.assert_allclose(npy(multioutput_multivariate_normal(x, mu, chol)), ref, rtol=1e-12)


def test_het_gaussian_simple_matches_jax():
    xs = np.linspace(0, 2, 5)
    X = np.stack([xs, np.zeros_like(xs)], axis=1)
    Y, cov = np.sin(xs)[:, None], np.eye(5) * 1e-3
    kw = {"likelihood_kwargs": {"init_scale": 1.7}}
    model = HeteroscedasticGPR((X, Y, cov), kernel=RBFDerivKernel(), likelihood_class=HetGaussianSimple, **kw)
    jmodel = jgm.HeteroscedasticGPR((X, Y, cov), kernel=jkern.RBFDerivKernel(), likelihood_class=jgm.HetGaussianSimple, **kw)
    assert model.trainable_names() == jmodel.trainable_names()
    _close_to_largest(model.log_marginal_likelihood(), np.asarray(jmodel.log_marginal_likelihood()), CORE_BAR)
    _close_to_largest(model.likelihood.build_scaled_cov_mat(X), np.asarray(jmodel.likelihood.build_scaled_cov_mat(X)), 1e-14)


def test_analytical_scale_matches_jax():
    """``calc_scale_v``, the concentrated LML and its gradient, and the
    scaled posterior against the JAX package."""
    X, Y, cov = _sine_data(seed=1)
    model = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel())
    jmodel = jgm.HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=jkern.RBFDerivKernel())
    for vec in (np.zeros(2), np.array([0.4, 1.1])):
        model.set_unconstrained(vec)
        jmodel.set_unconstrained(vec)
        _close_to_largest(model.calc_scale_v(), np.asarray(jmodel.calc_scale_v()), CORE_BAR)
        _close_to_largest(model.log_marginal_likelihood(), np.asarray(jmodel.log_marginal_likelihood()), CORE_BAR)
        with jgm._compute_ctx():
            jval, jgrad = jmodel._lml_fns()["neg_vag"](jnp.asarray(vec), *jmodel._bound_args())
        val, grad = model._lml_fns()["neg_vag"](torch.as_tensor(vec), *model._bound_args())
        _close_to_largest(val, np.asarray(jval), CORE_BAR)
        _close_grad(grad, np.asarray(jgrad), float(jval))
        Xt = np.stack([np.linspace(0.5, 5.5, 5), np.zeros(5)], axis=1)
        mean, var = model.predict_f(Xt)
        jmean, jvar = jmodel.predict_f(Xt)
        _close_to_largest(mean, np.asarray(jmean), CORE_BAR)
        _close_to_largest(var, np.asarray(jvar), CORE_BAR)


def _batched_models(pkg, kern):
    rng = np.random.default_rng(3)
    models = []
    for shift, p_val in [(0.0, 1.0), (0.3, 0.5), (-0.2, 2.0)]:
        xs = np.linspace(0.0, 2.0 * np.pi, 6) + shift
        X = np.concatenate([np.stack([xs, np.zeros_like(xs)], axis=1), np.stack([xs, np.ones_like(xs)], axis=1)])
        Y = np.concatenate([np.sin(xs) + rng.normal(0, 0.02, 6), np.cos(xs) + rng.normal(0, 0.05, 6)])[:, None]
        cov = np.diag(np.concatenate([np.full(6, 4e-4), np.full(6, 2.5e-3)]))
        m = pkg.HeteroscedasticGPR((X, Y, cov), kernel=kern(), likelihood_kwargs={"p": p_val})
        m.set_parameters({"kernel/l": 1.0 + 0.2 * shift, "kernel/var": 0.8})
        models.append(m)
    return models


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_f_batched_matches_jax(full_cov):
    Xt = np.stack([np.linspace(0.5, 5.5, 9), np.zeros(9)], axis=1)
    bm, bv = predict_f_batched(_batched_models(gm, RBFDerivKernel), Xt, full_cov=full_cov)
    jbm, jbv = jgm.predict_f_batched(_batched_models(jgm, jkern.RBFDerivKernel), Xt, full_cov=full_cov)
    _close_to_largest(bm, np.asarray(jbm), CORE_BAR)
    assert np.max(np.abs(npy(bv) - np.asarray(jbv))) <= CORE_BAR * 0.8


def test_params_file_matches_jax(tmp_path, sine_fits):
    """``save_params`` writes the JAX package's JSON, and each package loads
    the other's file."""
    model, _, jmodel, _ = sine_fits
    jmodel.save_params(tmp_path / "jax.json")
    model.save_params(tmp_path / "torch.json")
    assert json.loads((tmp_path / "jax.json").read_text()).keys() == json.loads((tmp_path / "torch.json").read_text()).keys()
    fresh = HeteroscedasticGPR(_sine_data(), kernel=RBFDerivKernel())
    jfresh = jgm.HeteroscedasticGPR(_sine_data(), kernel=jkern.RBFDerivKernel())
    jfresh.load_params(tmp_path / "torch.json")
    assert jfresh.parameters() == model.parameters()
    fresh.load_params(tmp_path / "jax.json")
    assert fresh.parameters() == jmodel.parameters()


@pytest.mark.parametrize("kind", ["constant", "linear", "sympy"])
def test_mean_functions_match_jax(rng_np, kind):
    x = rng_np.uniform(0.5, 1.5, size=(12, 1))
    y = np.concatenate([2.5 * x - 1.0, 3.0 * x**2], axis=1)
    X = np.array([[0.2, 0.0], [0.4, 1.0], [0.6, 2.0], [1.1, 0.0], [0.9, 3.0]])
    if kind == "constant":
        got, ref = ConstantMeanWithDerivs(y)(X), jgm.ConstantMeanWithDerivs(y)(X)
    elif kind == "linear":
        got, ref = LinearWithDerivs(x, y)(X), jgm.LinearWithDerivs(x, y)(X)
    else:
        a_sym, x_sym = sp.symbols("a x", real=True)
        got = SympyMeanFunc(a_sym * x_sym**2, x, y[:, 1:])(X)
        with jgm._compute_ctx():
            ref = jgm.SympyMeanFunc(a_sym * x_sym**2, x, y[:, 1:])(X)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_not_ported_names_raise():
    """The two noise-GP names resolve from ``experimental``, as in the JAX
    package (they raised until it was ported); other names raise."""
    from thermoextrap_tpu_torch.gpr_active import experimental

    for name in ("HetGaussianNoiseGP", "FullyHeteroscedasticGPR"):
        assert getattr(gm, name) is getattr(experimental, name)
    with pytest.raises(AttributeError):
        gm.no_such_name  # noqa: B018


# -- the mirror of tests/test_gps.py -----------------------------------------------------------


class TestDerivativeKernel:
    @pytest.fixture(scope="class")
    def rbf(self):
        return RBFDerivKernel()

    def test_k_vs_closed_form(self, rbf):
        var, ell = 1.7, 0.9
        xs = np.array([-0.3, 0.1, 0.5, 1.2])
        for d1 in range(5):
            for d2 in range(5):
                X1 = np.stack([xs, np.full_like(xs, d1)], axis=1)
                X2 = np.stack([xs, np.full_like(xs, d2)], axis=1)
                got = npy(rbf.K(X1, X2, params={"var": var, "l": ell}))
                expected = rbf_deriv_closed_form(xs[:, None], xs[None, :], d1, d2, var, ell)
                np.testing.assert_allclose(got, expected, rtol=1e-10, atol=1e-12)

    def test_multidim_rbf_closed_form(self):
        ells, var = (0.8, 1.6), 1.3
        expr, params = make_rbf_expr(2)
        kern = DerivativeKernel(expr, 2, kernel_params=params)
        pts = np.array([[0.0, 0.4], [0.5, 0.2], [0.1, 0.9], [1.0, -0.3]])
        pvals = {"var": var, "l_0": ells[0], "l_1": ells[1]}
        for orders1 in [(0, 0), (1, 0), (0, 2), (2, 1), (1, 2), (2, 2)]:
            for orders2 in [(0, 0), (0, 1), (2, 0), (1, 1), (2, 2)]:
                X1 = np.concatenate([pts, np.broadcast_to(orders1, pts.shape)], axis=1)
                X2 = np.concatenate([pts, np.broadcast_to(orders2, pts.shape)], axis=1)
                got = npy(kern.K(X1, X2, params=pvals))
                expected = np.ones((len(pts), len(pts)))
                for dim in range(2):
                    v = var if dim == 0 else 1.0
                    expected = expected * rbf_deriv_closed_form(
                        pts[:, None, dim], pts[None, :, dim], orders1[dim], orders2[dim], v, ells[dim]
                    )
                np.testing.assert_allclose(got, expected, rtol=1e-10, atol=1e-12)

    def test_k_vs_finite_difference(self, rbf):
        var, ell = 1.7, 0.9
        f = lambda a, b: var * np.exp(-0.5 * ((a - b) / ell) ** 2)  # noqa: E731
        xs = np.array([0.1, 0.5, 1.2])
        for d1 in range(3):
            for d2 in range(3):
                h = (1e-16) ** (1.0 / (d1 + d2 + 2))
                X1 = np.stack([xs, np.full_like(xs, d1)], axis=1)
                X2 = np.stack([xs, np.full_like(xs, d2)], axis=1)
                got = npy(rbf.K(X1, X2, params={"var": var, "l": ell}))
                for i, a in enumerate(xs):
                    for j, b in enumerate(xs):
                        np.testing.assert_allclose(got[i, j], fd_mixed_partial(f, a, b, d1, d2, h=h), rtol=5e-2, atol=1e-4)

    def test_mixed_orders_one_matrix(self, rbf):
        X = np.array([[0.0, 0.0], [0.0, 1.0], [0.5, 2.0], [1.0, 0.0]])
        K = npy(rbf.K(X))
        assert K.shape == (4, 4)
        np.testing.assert_allclose(K, K.T, rtol=1e-10)

    def test_k_diag_matches_k(self, rbf):
        X = np.array([[0.0, 0.0], [0.3, 1.0], [0.7, 2.0], [0.9, 1.0]])
        np.testing.assert_allclose(np.diag(npy(rbf.K(X))), npy(rbf.K_diag(X)), rtol=1e-12)

    @pytest.mark.parametrize("factory", [make_matern_expr, make_poly_expr])
    def test_other_kernels_fd(self, factory):
        expr, params = factory(3)
        kern = DerivativeKernel(expr, 1, kernel_params=params)
        x1s, x2s = sp.symbols("x1 x2", real=True)
        ell, var = sp.symbols("l var", real=True)
        base = sp.lambdify((x1s, x2s, ell, var), expr, modules="numpy")
        f = lambda a, b: base(a, b, 1.3, 0.8)  # noqa: E731
        xs1, xs2 = np.array([0.4, 0.9]), np.array([0.15, 0.7])
        for d1, d2 in [(0, 0), (1, 0), (1, 1), (2, 1)]:
            h = (1e-16) ** (1.0 / (d1 + d2 + 2))
            X1 = np.stack([xs1, np.full_like(xs1, d1)], axis=1)
            X2 = np.stack([xs2, np.full_like(xs2, d2)], axis=1)
            got = npy(kern.K(X1, X2, params={"l": 1.3, "var": 0.8}))
            for i, a in enumerate(xs1):
                for j, b in enumerate(xs2):
                    np.testing.assert_allclose(got[i, j], fd_mixed_partial(f, a, b, d1, d2, h=h), rtol=5e-2, atol=1e-4)

    def test_multidim_rbf(self):
        expr, params = make_rbf_expr(2)
        kern = DerivativeKernel(expr, 2, kernel_params=params)
        X = np.array([[0.0, 0.0, 0.0, 0.0], [0.5, 0.2, 1.0, 0.0], [0.1, 0.9, 0.0, 1.0]])
        K = npy(kern.K(X))
        assert K.shape == (3, 3)
        np.testing.assert_allclose(K, K.T, rtol=1e-10)
        np.testing.assert_allclose(np.diag(K), npy(kern.K_diag(X)), rtol=1e-12)


class TestLikelihood:
    def test_multioutput_mvn_vs_scipy(self, rng_np):
        n, d = 6, 3
        x, mu = rng_np.normal(size=(n, d)), rng_np.normal(size=(n, d))
        covs = []
        for _ in range(d):
            a = rng_np.normal(size=(n, n))
            covs.append(a @ a.T + n * np.eye(n))
        covs = np.stack(covs)
        got = npy(multioutput_multivariate_normal(x, mu, np.linalg.cholesky(covs)))
        for k in range(d):
            np.testing.assert_allclose(got[k], stats.multivariate_normal.logpdf(x[:, k], mu[:, k], covs[k]), rtol=1e-9)

    def test_scaled_cov(self):
        n = 4
        lik = HetGaussianDeriv(np.eye(n) * 2.0, obs_dims=1, p=0.5, s=0.0)
        X = np.array([[0.0, 0.0], [0.0, 1.0], [0.0, 2.0], [1.0, 0.0]])
        expected = np.diag(2.0 * np.exp(2 * 0.5 * (X[:, 1] + 1))) + 1e-12 * np.eye(n)
        np.testing.assert_allclose(npy(lik.build_scaled_cov_mat(X))[0], expected, rtol=1e-10)


class TestMeanFunctions:
    def test_constant(self):
        mf = ConstantMeanWithDerivs(np.array([[1.0], [3.0]]))
        X = np.array([[0.0, 0.0], [0.5, 1.0], [1.0, 0.0]])
        np.testing.assert_allclose(npy(mf(X))[:, 0], [2.0, 0.0, 2.0], rtol=1e-12)

    def test_linear(self, rng_np):
        x = rng_np.uniform(size=(10, 1))
        mf = LinearWithDerivs(x, 2.5 * x - 1.0)
        out = npy(mf(np.array([[0.2, 0.0], [0.4, 1.0], [0.6, 2.0]])))[:, 0]
        np.testing.assert_allclose(out[0], 2.5 * 0.2 - 1.0, rtol=1e-8)
        np.testing.assert_allclose(out[1], 2.5, rtol=1e-8)
        np.testing.assert_allclose(out[2], 0.0, atol=1e-10)

    def test_sympy_mean(self, rng_np):
        a_sym, x_sym = sp.symbols("a x", real=True)
        x = rng_np.uniform(0.5, 1.5, size=(20, 1))
        mf = SympyMeanFunc(a_sym * x_sym**2, x, 3.0 * x**2)
        np.testing.assert_allclose(mf.param_values["a"], 3.0, rtol=1e-5)
        out = npy(mf(np.array([[1.0, 0.0], [1.0, 1.0], [1.0, 2.0], [1.0, 3.0]])))[:, 0]
        np.testing.assert_allclose(out, [3.0, 6.0, 6.0, 0.0], rtol=1e-5, atol=1e-8)


class TestHeteroscedasticGPR:
    def test_trains(self, sine_fit):
        model, res = sine_fit
        assert np.isfinite(res.fun)
        params = model.parameters()
        assert params["kernel/l"] > 0
        assert params["kernel/var"] > 0

    def test_logwhitened_lml_identity(self, sine_fit):
        model, res = sine_fit
        fns, bound = model._lml_fns(), model._bound_args()
        for vec in (res.x, np.zeros_like(res.x), np.full_like(res.x, 0.7)):
            v = float(fns["lml"](torch.as_tensor(vec), *bound))
            w = float(fns["lml_logw"](torch.as_tensor(vec), *bound))
            assert abs(v - w) < 1e-8 * max(1.0, abs(v))

    def test_logwhitened_zero_cov_rows_extreme_scale(self, sine_fit):
        model0, _ = sine_fit
        cov = np.asarray(model0.likelihood.cov_np)[0].copy()
        n = cov.shape[0]
        cov[n // 2 :, :] = 0.0
        cov[:, n // 2 :] = 0.0
        for s in (0.0, 100.0, 250.0, 300.0):
            model = HeteroscedasticGPR(
                (model0.X, model0._y_np, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 10.0, "s": s}
            )
            fns, bound = model._lml_fns(), model._bound_args()
            vec = model.get_unconstrained()
            v = float(fns["lml"](vec, *bound))
            w = float(fns["lml_logw"](vec, *bound))
            assert abs(v - w) < 1e-8 * max(1.0, abs(v)), (s, v, w)
            b32 = [b.float() if b.is_floating_point() else b for b in bound]
            w32 = float(fns["lml_logw"](vec.float(), *b32))
            assert np.isfinite(w32), (s, w32)
            assert abs(w32 - v) < 1e-4 * max(1.0, abs(v)), (s, v, w32)

    def test_on_device_f32_train_reaches_f64_optimum(self, sine_fit):
        model64, res64 = sine_fit
        cov = np.asarray(model64.likelihood.cov_np)[0]
        model = HeteroscedasticGPR((model64.X, model64._y_np, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
        x0 = npy(model.get_unconstrained())
        res = model.train(on_device=True)
        nll64_at = float(model64.neg_lml(np.asarray(res.x, np.float64)))
        assert np.isfinite(res.fun)
        assert not np.array_equal(np.asarray(res.x), x0)  # not rolled back
        assert nll64_at <= float(res64.fun) + 0.05

    def test_on_device_f32_train_is_float32_as_jax(self):
        """The float32 fit computes in float32 throughout, as the JAX
        package's: the closed-form RBF block of float32 locations is float32
        (its derivative orders took float64 and promoted the block, so the
        fit factored W in float64), and on data where the float32 objective
        stops L-BFGS-B early both packages stop at the same point."""
        from scipy import linalg

        from thermoextrap_tpu.gpr_active import active_utils as jau
        from thermoextrap_tpu_torch.gpr_active import active_utils as au
        from thermoextrap_tpu_torch.gpr_active import ig_active

        locs = torch.linspace(0.0, 1.0, 4, dtype=torch.float32)[:, None]
        gid = torch.tensor([0, 1, 0, 1])
        block = RBFDerivKernel()._pair_matrix(locs, gid, ((0,), (1,)), locs, gid, ((0,), (1,)), [torch.tensor(0.8), torch.tensor(1.3)])
        assert block.dtype == torch.float32
        staged = [
            au.input_GP_from_state(ig_active.extrap_IG(b, rng=torch.Generator().manual_seed(10 + k), nconfig=10_000, npart=1_000, order=4))
            for k, b in enumerate((0.5, 1.0, 1.5, 2.0, 2.5))
        ]
        data = (
            np.vstack([d[0] for d in staged]),
            np.vstack([d[1] for d in staged]),
            np.array([linalg.block_diag(*[d[2][0] for d in staged])]),
        )
        model = au.create_base_GP_model(data)
        bound32 = [b.float() if b.is_floating_point() else b for b in model._bound_args()]
        assert model._lml_fns()["lml_logw"](model.get_unconstrained().float(), *bound32).dtype == torch.float32
        res = model.train(on_device=True)
        jmodel = jau.create_base_GP_model(data)
        jres = jmodel.train(on_device=True)
        model64 = au.create_base_GP_model(data)
        res64 = model64.train()
        gap = float(model64.neg_lml(model.get_unconstrained())) - res64.fun
        jgap = float(model64.neg_lml(torch.as_tensor(np.array(jmodel.get_unconstrained())))) - res64.fun
        assert gap > 1.0 and jgap > 1.0  # this data stops both float32 fits early
        assert gap == pytest.approx(jgap, abs=1e-3) and res.nfev == jres.nfev

    def test_prediction_accuracy(self, sine_fit):
        model, _ = sine_fit
        xt = np.linspace(0.5, 5.5, 11)
        mean, var = model.predict_f(np.stack([xt, np.zeros_like(xt)], axis=1))
        err = np.abs(npy(mean)[:, 0] - np.sin(xt))
        assert np.all(err < np.maximum(4 * np.sqrt(npy(var)[:, 0]), 0.1))

    def test_derivative_prediction(self, sine_fit):
        model, _ = sine_fit
        xt = np.linspace(1.0, 5.0, 5)
        mean, _var = model.predict_f(np.stack([xt, np.ones_like(xt)], axis=1))
        assert np.max(np.abs(npy(mean)[:, 0] - np.cos(xt))) < 0.25

    def test_full_cov_consistent(self, sine_fit):
        model, _ = sine_fit
        xt = np.linspace(1.0, 5.0, 4)
        Xt = np.stack([xt, np.zeros_like(xt)], axis=1)
        _m1, v_diag = model.predict_f(Xt, full_cov=False)
        _m2, v_full = model.predict_f(Xt, full_cov=True)
        np.testing.assert_allclose(npy(v_diag)[:, 0], np.diag(npy(v_full)[0]), rtol=1e-8, atol=1e-12)

    def test_lml_improves_with_training(self):
        rng = np.random.default_rng(1)
        xs = np.linspace(0, 3, 5)
        y = (xs**2 + rng.normal(0, 0.01, xs.shape))[:, None]
        model = HeteroscedasticGPR((np.stack([xs, np.zeros_like(xs)], axis=1), y, np.eye(5) * 1e-4), kernel=RBFDerivKernel())
        before = float(model.log_marginal_likelihood())
        model.train()
        assert float(model.log_marginal_likelihood()) >= before

    def test_multioutput(self):
        xs = np.linspace(0, 1, 6)
        X = np.stack([xs, np.zeros_like(xs)], axis=1)
        Y = np.stack([np.sin(xs), 10 * np.cos(xs)], axis=1)
        model = HeteroscedasticGPR((X, Y, np.eye(6) * 1e-4), kernel=RBFDerivKernel(), scale_fac=[1.0, 10.0])
        model.train(max_iter=200)
        mean, _var = model.predict_f(X)
        assert npy(mean).shape == (6, 2)
        np.testing.assert_allclose(npy(mean), Y, atol=0.15)


class TestCallableDerivativeKernel:
    def test_matches_sympy_rbf(self):
        """Nested ``torch.func.grad`` kernel == the closed-form RBF == the
        sympy-differentiated RBF."""
        k_call = CallableDerivativeKernel(_torch_rbf, obs_dims=1, kernel_params={"var": 1.4, "l": 0.8})
        params = {"var": 1.4, "l": 0.8}
        X = np.array([[0.1, 0.0], [0.4, 1.0], [0.9, 2.0], [1.3, 0.0], [0.6, 3.0]])
        K1 = npy(k_call.K(X))
        for k_ref in (RBFDerivKernel(), DerivativeKernel(*make_rbf_expr()[:1], 1, make_rbf_expr()[1])):
            np.testing.assert_allclose(K1, npy(k_ref.K(X, params=params)), rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(npy(k_call.K_diag(X)), npy(k_ref.K_diag(X, params=params)), rtol=1e-8)

    def test_trains_in_gpr(self):
        xs = np.linspace(0, 3, 6)
        y = np.sin(xs)[:, None]
        X = np.stack([xs, np.zeros_like(xs)], axis=1)
        model = HeteroscedasticGPR(
            (X, y, np.eye(6) * 1e-4), kernel=CallableDerivativeKernel(_torch_rbf, kernel_params={"var": 1.0, "l": 1.0})
        )
        model.train(max_iter=100)
        mu, _ = model.predict_f(X)
        np.testing.assert_allclose(npy(mu), y, atol=0.05)

    def test_distinct_fns_use_distinct_compiled_cores(self):
        def cosine(x1, x2, var, ell):
            return var * torch.cos((x1[0] - x2[0]) / ell)

        xs = np.linspace(0, 3, 6)
        data = (np.stack([xs, np.zeros_like(xs)], axis=1), np.sin(xs)[:, None], np.eye(6) * 1e-4)
        m1 = HeteroscedasticGPR(data, kernel=CallableDerivativeKernel(_torch_rbf, kernel_params={"var": 1.0, "l": 1.0}))
        m2 = HeteroscedasticGPR(data, kernel=CallableDerivativeKernel(cosine, kernel_params={"var": 1.0, "l": 1.0}))
        assert m1._structure_key() != m2._structure_key()
        assert float(m1.log_marginal_likelihood()) != float(m2.log_marginal_likelihood())


class TestAnalyticalScaleGPR:
    @pytest.fixture(scope="class")
    def sine_data(self):
        return _sine_data(seed=1)

    def test_concentrated_lml_formula(self, sine_data):
        X, Y, cov = sine_data
        model = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel())
        lml = float(model.log_marginal_likelihood())
        sf = float(npy(model.scale_fac)[0])
        ks = npy(model.kernel.K(X)) + cov / sf**2 + 1e-12 * np.eye(len(X))
        ell = np.linalg.cholesky(ks)
        alpha = np.linalg.solve(ell, Y[:, 0] / sf)
        n = len(X)
        v = float(alpha @ alpha) / n
        expect = -0.5 * n * np.log(v) - 0.5 * n * np.log(2 * np.pi) - np.sum(np.log(np.diag(ell))) - 0.5 * n
        np.testing.assert_allclose(lml, expect, rtol=1e-9)
        np.testing.assert_allclose(float(npy(model.calc_scale_v())[0]), v, rtol=1e-9)

    def test_mean_matches_standard_var_scales_by_v(self, sine_data):
        X, Y, cov = sine_data
        model_v = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel(), scale_fac=1.0)
        model_s = HeteroscedasticGPR(
            (X, Y, cov),
            kernel=RBFDerivKernel(),
            likelihood_kwargs={"p": 0.0, "constrain_p": True, "transform_p": "none"},
        )
        Xt = np.stack([np.linspace(0.5, 5.5, 7), np.zeros(7)], axis=1)
        mu_v, var_v = (npy(a) for a in model_v.predict_f(Xt))
        mu_s, var_s = (npy(a) for a in model_s.predict_f(Xt))
        v = float(npy(model_v.calc_scale_v())[0])
        np.testing.assert_allclose(mu_v, mu_s, rtol=1e-8)
        np.testing.assert_allclose(var_v, var_s * v, rtol=1e-8)

    def test_trains_and_predicts(self, sine_data):
        X, Y, cov = sine_data
        model = HeteroscedasticGPRAnalyticalScale((X, Y, cov), kernel=RBFDerivKernel())
        res = model.train()
        assert np.isfinite(res.fun)
        assert float(npy(model.calc_scale_v())[0]) > 0
        xt = np.linspace(0.5, 5.5, 11)
        mean, var = model.predict_f(np.stack([xt, np.zeros_like(xt)], axis=1))
        err = np.abs(npy(mean)[:, 0] - np.sin(xt))
        assert np.all(err < np.maximum(4 * np.sqrt(npy(var)[:, 0]), 0.1))

    def test_create_base_gp_model_class(self, sine_data):
        from thermoextrap_tpu_torch.gpr_active import active_utils as au

        model = au.create_base_GP_model(sine_data, model_class=HeteroscedasticGPRAnalyticalScale)
        assert isinstance(model, HeteroscedasticGPRAnalyticalScale)
        assert np.isfinite(model.train(max_iter=50).fun)


class TestHetGaussianSimple:
    def test_scaled_cov_is_scalar_multiple(self):
        rng = np.random.default_rng(3)
        a = rng.normal(size=(5, 5))
        cov = a @ a.T + 5 * np.eye(5)
        lik = HetGaussianSimple(cov, obs_dims=1, init_scale=2.5)
        X = np.array([[0.0, 0.0], [0.1, 1.0], [0.2, 2.0], [0.3, 3.0], [0.4, 0.0]])
        np.testing.assert_allclose(npy(lik.build_scaled_cov_mat(X))[0], 2.5 * cov + np.diag(np.full(5, 1e-12)), rtol=1e-10)
        np.testing.assert_allclose(lik.scale_noise, 2.5, rtol=1e-12)

    def test_lml_matches_deriv_special_case(self):
        xs = np.linspace(0, 2, 5)
        data = (np.stack([xs, np.zeros_like(xs)], axis=1), np.sin(xs)[:, None], np.eye(5) * 1e-3)
        m_simple = HeteroscedasticGPR(
            data, kernel=RBFDerivKernel(), likelihood_class=HetGaussianSimple, likelihood_kwargs={"init_scale": 1.7}
        )
        m_deriv = HeteroscedasticGPR(
            data,
            kernel=RBFDerivKernel(),
            likelihood_kwargs={
                "p": 0.0,
                "s": float(np.log(1.7)),
                "constrain_p": True,
                "constrain_s": True,
                "transform_p": "none",
                "transform_s": "none",
            },
        )
        np.testing.assert_allclose(float(m_simple.log_marginal_likelihood()), float(m_deriv.log_marginal_likelihood()), rtol=1e-10)

    def test_trains(self):
        rng = np.random.default_rng(0)
        xs = np.linspace(0.0, 2.0 * np.pi, 10)
        y = (np.sin(xs) + rng.normal(0, 0.05, xs.shape))[:, None]
        X = np.stack([xs, np.zeros_like(xs)], axis=1)
        model = HeteroscedasticGPR((X, y, np.eye(10) * 0.05**2), kernel=RBFDerivKernel(), likelihood_class=HetGaussianSimple)
        assert np.isfinite(model.train().fun)
        assert model.likelihood.scale_noise > 0
        assert "likelihood/s" in model.trainable_names()
        assert "likelihood/p" not in model.trainable_names()
        mu, _ = model.predict_f(X)
        np.testing.assert_allclose(npy(mu), y, atol=0.2)


class TestPredictFBatched:
    def test_matches_per_model(self):
        models = _batched_models(gm, RBFDerivKernel)
        Xt = np.stack([np.linspace(0.5, 5.5, 9), np.zeros(9)], axis=1)
        bm, bv = (npy(a) for a in predict_f_batched(models, Xt))
        assert bm.shape == (3, 9, 1) and bv.shape == (3, 9, 1)
        for i, m in enumerate(models):
            mu, var = m.predict_f(Xt)
            np.testing.assert_allclose(bm[i], npy(mu), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(bv[i], npy(var), rtol=1e-10, atol=1e-12)

    def test_rejects_structure_mismatch(self):
        m1, m2 = _batched_models(gm, RBFDerivKernel)[:2]
        m2._groups = m1._groups
        m2._locs_np = m2._locs_np[:-1]
        m2.X = m2.X[:-1]
        with pytest.raises(ValueError, match="structurally identical"):
            predict_f_batched([m1, m2], np.array([[1.0, 0.0]]))

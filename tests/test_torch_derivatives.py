r"""Exact end-to-end gate of the torch port's derivative engine: the port of
tests/test_derivatives.py.

Oracle: a discrete Boltzmann ensemble of M configurations with energies u_c,
weights w_c and observable x_c.  Every observable is then an explicit
elementary function of beta,

    <A>(beta) = sum_c A_c w_c exp(-beta u_c) / sum_c w_c exp(-beta u_c),

which sympy differentiates exactly.  The same distribution goes through the
port's data layer (a weighted float64 reduction with weights proportional to
the Boltzmann factors at beta0), the series engine and the β / lnΠ
factories, so the port must match sympy to float64 roundoff, at the JAX
test's own tolerances.  Each sympy oracle is computed once per module and
shared by the raw and central cases.
"""

import math

import numpy as np
import pytest
import sympy as sp
from _torch_parity import npy, tt

import thermoextrap_tpu_torch as tx
from thermoextrap_tpu_torch import beta as beta_xpan
from thermoextrap_tpu_torch import lnpi as lnpi_xpan

ORDER = 6
BETA0 = 1.3


@pytest.fixture(scope="module")
def discrete():
    rng = np.random.default_rng(7)
    m = 12
    u_c = rng.uniform(0.5, 2.0, size=m)
    w_c = rng.uniform(0.5, 1.5, size=m)
    x_c = rng.uniform(1.0, 3.0, size=(m, 2))  # 2-vector observable
    return u_c, w_c, x_c


def sym_ensemble_avg(expr_per_config, u_c, w_c, b):
    """<expr>(beta) as an exact sympy expression."""
    z = sum(sp.Rational(1) * sp.nsimplify(w) * sp.exp(-b * sp.nsimplify(u)) for w, u in zip(w_c, u_c))
    num = sum(e * sp.nsimplify(w) * sp.exp(-b * sp.nsimplify(u)) for e, w, u in zip(expr_per_config, w_c, u_c))
    return num / z


def sym_derivs(expr, b, order):
    out = []
    d = expr
    for k in range(order + 1):
        if k > 0:
            d = sp.diff(d, b)
        out.append(float(d.subs(b, sp.nsimplify(BETA0)).evalf(30)))
    return np.array(out)


def boltzmann_weights(u_c, w_c):
    return w_c * np.exp(-BETA0 * (u_c - u_c.mean()))


def data_values(uv, xv, order, central, weight, **kws):
    return tx.factory_data_values(
        uv=tt(uv), xv=None if xv is None else tt(xv), order=order, central=central, weight=tt(weight), **kws
    )


@pytest.fixture(scope="module")
def oracle_x(discrete):
    """Exact derivatives of <x_0>(beta) (first vector component)."""
    u_c, w_c, x_c = discrete
    b = sp.symbols("b")
    return sym_derivs(sym_ensemble_avg([sp.nsimplify(v) for v in x_c[:, 0]], u_c, w_c, b), b, ORDER)


@pytest.fixture(scope="module")
def oracle_minus_log(discrete):
    u_c, w_c, x_c = discrete
    b = sp.symbols("b")
    return sym_derivs(-sp.log(sym_ensemble_avg([sp.nsimplify(v) for v in x_c[:, 0]], u_c, w_c, b)), b, ORDER)


@pytest.fixture(scope="module")
def xalpha_cfg(discrete):
    """Beta-dependent observable x_c(beta) = a_c + b_c beta + c_c beta^2 and
    the exact derivatives of its average."""
    u_c, w_c, _ = discrete
    abc = np.random.default_rng(3).uniform(0.5, 1.5, size=(len(u_c), 3))
    b = sp.symbols("b")
    exprs = [sp.nsimplify(a) + sp.nsimplify(bb) * b + sp.nsimplify(c) * b**2 for a, bb, c in abc]
    return abc, sym_derivs(sym_ensemble_avg(exprs, u_c, w_c, b), b, ORDER)


@pytest.fixture(scope="module")
def oracle_u(discrete):
    u_c, w_c, _ = discrete
    b = sp.symbols("b")
    return sym_derivs(sym_ensemble_avg([sp.nsimplify(v) for v in u_c], u_c, w_c, b), b, ORDER)


@pytest.fixture(scope="module")
def lnpi_case(discrete):
    """lnPi over a 3-state macrostate grid: each macrostate has its own
    discrete energy ensemble; lnPi' = mu N - <u>_N exactly."""
    u_c, w_c, _ = discrete
    rng = np.random.default_rng(11)
    n_grid = 3
    mu = 0.7
    lnpi0 = rng.normal(size=n_grid)
    ncoords = np.arange(n_grid, dtype=float)
    shifts = rng.uniform(-0.3, 0.3, size=n_grid)
    u_grid = u_c[None, :] + shifts[:, None]  # (n_grid, M)

    b = sp.symbols("b")
    expected = np.zeros((ORDER + 1, n_grid))
    for i in range(n_grid):
        d = sym_ensemble_avg([sp.nsimplify(v) for v in u_grid[i]], u_grid[i], w_c, b)
        # lnPi(beta) = lnpi0 + (beta - beta0) mu N - int <u>
        expected[0, i] = lnpi0[i]
        for k in range(1, ORDER + 1):
            val = -float(d.subs(b, sp.nsimplify(BETA0)).evalf(30))
            expected[k, i] = val + (mu * ncoords[i] if k == 1 else 0.0)
            d = sp.diff(d, b)
    return u_grid, lnpi0, mu, ncoords, expected


class TestXAve:
    @pytest.mark.parametrize("central", [False, True])
    def test_exact(self, discrete, oracle_x, central):
        u_c, w_c, x_c = discrete
        data = data_values(u_c, x_c, ORDER, central, boltzmann_weights(u_c, w_c))
        derivs = npy(beta_xpan.factory_extrapmodel(BETA0, data).derivs())  # (order+1, val)
        np.testing.assert_allclose(derivs[:, 0], oracle_x, rtol=1e-9)

    @pytest.mark.parametrize("central", [False, True])
    def test_minus_log(self, discrete, oracle_minus_log, central):
        u_c, w_c, x_c = discrete
        data = data_values(u_c, x_c, ORDER, central, boltzmann_weights(u_c, w_c))
        derivs = npy(beta_xpan.factory_extrapmodel(BETA0, data, minus_log=True).derivs())
        np.testing.assert_allclose(derivs[:, 0], oracle_minus_log, rtol=1e-8)

    def test_predict_matches_taylor(self, discrete, oracle_x):
        u_c, w_c, x_c = discrete
        data = data_values(u_c, x_c, ORDER, True, boltzmann_weights(u_c, w_c))
        betas = np.array([1.1, 1.3, 1.45])
        pred = npy(beta_xpan.factory_extrapmodel(BETA0, data).predict(tt(betas)))
        for i, bb in enumerate(betas):
            expected = sum(oracle_x[k] * (bb - BETA0) ** k / math.factorial(k) for k in range(ORDER + 1))
            np.testing.assert_allclose(pred[i, 0], expected, rtol=1e-9)


class TestXAveXalpha:
    """Beta-dependent observable x_c(beta) = a_c + b_c*beta + c_c*beta^2."""

    @pytest.mark.parametrize("central", [False, True])
    def test_exact(self, discrete, xalpha_cfg, central):
        u_c, w_c, _ = discrete
        abc, expected = xalpha_cfg
        # samples of x^{(d)} at beta0, d = 0..ORDER (zero beyond d=2)
        deriv_vals = np.zeros((len(u_c), ORDER + 1, 1))
        deriv_vals[:, 0, 0] = abc[:, 0] + abc[:, 1] * BETA0 + abc[:, 2] * BETA0**2
        deriv_vals[:, 1, 0] = abc[:, 1] + 2 * abc[:, 2] * BETA0
        deriv_vals[:, 2, 0] = 2 * abc[:, 2]
        data = data_values(u_c, deriv_vals, ORDER, central, boltzmann_weights(u_c, w_c), xalpha=True)
        derivs = npy(beta_xpan.factory_extrapmodel(BETA0, data).derivs())
        np.testing.assert_allclose(derivs[:, 0], expected, rtol=1e-8)


class TestUAve:
    @pytest.mark.parametrize("central", [False, True])
    def test_exact(self, discrete, oracle_u, central):
        u_c, w_c, _ = discrete
        data = data_values(u_c, None, ORDER + 1, central, boltzmann_weights(u_c, w_c), x_is_u=True)
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="u_ave", order=ORDER)
        np.testing.assert_allclose(npy(model.derivs(order=ORDER)), oracle_u, rtol=1e-9)


class TestMomentObservables:
    def test_un_ave(self, discrete):
        u_c, w_c, _ = discrete
        n = 2
        b = sp.symbols("b")
        expected = sym_derivs(sym_ensemble_avg([sp.nsimplify(v) ** n for v in u_c], u_c, w_c, b), b, 3)
        data = data_values(u_c, None, n + 3 + 1, False, boltzmann_weights(u_c, w_c), x_is_u=True)
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="un_ave", n=n, order=3)
        np.testing.assert_allclose(npy(model.derivs(order=3)), expected, rtol=1e-9)

    def test_dun_ave(self, discrete):
        u_c, w_c, _ = discrete
        n, dorder = 2, 3
        b = sp.symbols("b")
        uave = sym_ensemble_avg([sp.nsimplify(v) for v in u_c], u_c, w_c, b)
        expr = sym_ensemble_avg([(sp.nsimplify(v) - uave) ** n for v in u_c], u_c, w_c, b)
        expected = sym_derivs(expr, b, dorder)
        data = data_values(u_c, None, n + dorder + 1, True, boltzmann_weights(u_c, w_c), x_is_u=True)
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="dun_ave", n=n, order=dorder)
        np.testing.assert_allclose(npy(model.derivs(order=dorder)), expected, rtol=1e-8)

    def test_xun_ave(self, discrete):
        u_c, w_c, x_c = discrete
        n, dorder = 2, 3
        b = sp.symbols("b")
        expr = sym_ensemble_avg(
            [sp.nsimplify(x) * sp.nsimplify(u) ** n for x, u in zip(x_c[:, 0], u_c)], u_c, w_c, b
        )
        expected = sym_derivs(expr, b, dorder)
        data = data_values(u_c, x_c, n + dorder, False, boltzmann_weights(u_c, w_c))
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="xun_ave", n=n, order=dorder)
        np.testing.assert_allclose(npy(model.derivs(order=dorder))[:, 0], expected, rtol=1e-8)

    def test_dxdun_ave(self, discrete):
        u_c, w_c, x_c = discrete
        n, dorder = 2, 3
        b = sp.symbols("b")
        uave = sym_ensemble_avg([sp.nsimplify(v) for v in u_c], u_c, w_c, b)
        xave = sym_ensemble_avg([sp.nsimplify(v) for v in x_c[:, 0]], u_c, w_c, b)
        expr = sym_ensemble_avg(
            [(sp.nsimplify(x) - xave) * (sp.nsimplify(u) - uave) ** n for x, u in zip(x_c[:, 0], u_c)],
            u_c,
            w_c,
            b,
        )
        expected = sym_derivs(expr, b, dorder)
        data = data_values(u_c, x_c, n + dorder + 1, True, boltzmann_weights(u_c, w_c))
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="dxdun_ave", n=n, order=dorder)
        np.testing.assert_allclose(npy(model.derivs(order=dorder))[:, 0], expected, rtol=1e-8)


class TestLnPi:
    @pytest.mark.parametrize("central", [False, True])
    def test_exact(self, discrete, lnpi_case, central):
        _, w_c, _ = discrete
        u_grid, lnpi0, mu, ncoords, expected = lnpi_case
        weight = np.stack([boltzmann_weights(row, w_c) for row in u_grid])
        meta = lnpi_xpan.lnPiDataCallback.from_mu(tt(lnpi0), [mu], tt(ncoords[None, :]))
        data = data_values(u_grid, None, ORDER, central, weight, x_is_u=True, meta=meta)
        derivs = npy(lnpi_xpan.factory_extrapmodel_lnPi(BETA0, data).derivs())  # order = data.order + 1
        np.testing.assert_allclose(derivs[: ORDER + 1], expected, rtol=1e-9)


class TestXalphaMomentObservables:
    """xalpha variants of the moment observables (d-indexed columns)."""

    @staticmethod
    def _poly_cfg():
        return np.random.default_rng(5).uniform(0.5, 1.5, size=(12, 3))  # x_c(b) = a + b*beta + c*beta^2

    @staticmethod
    def _xsym(abc):
        b = sp.symbols("b")
        return b, [sp.nsimplify(a) + sp.nsimplify(bb) * b + sp.nsimplify(c) * b**2 for a, bb, c in abc]

    @staticmethod
    def _deriv_data(u_c, w_c, abc, order, central):
        deriv_vals = np.zeros((len(u_c), order + 1 + 2, 1))
        deriv_vals[:, 0, 0] = abc[:, 0] + abc[:, 1] * BETA0 + abc[:, 2] * BETA0**2
        deriv_vals[:, 1, 0] = abc[:, 1] + 2 * abc[:, 2] * BETA0
        deriv_vals[:, 2, 0] = 2 * abc[:, 2]
        return data_values(u_c, deriv_vals, order, central, boltzmann_weights(u_c, w_c), xalpha=True)

    def test_xun_ave_xalpha(self, discrete):
        u_c, w_c, _ = discrete
        abc = self._poly_cfg()
        n, d, dorder = 1, 1, 3
        b, exprs = self._xsym(abc)
        # observable: x^{(d)}(b) * u^n with x^{(1)} = dx/db per config
        expected = sym_derivs(
            sym_ensemble_avg([sp.diff(e, b, d) * sp.nsimplify(uu) ** n for e, uu in zip(exprs, u_c)], u_c, w_c, b),
            b,
            dorder,
        )
        data = self._deriv_data(u_c, w_c, abc, n + dorder + 2, central=False)
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="xun_ave", n=n, d=d, xalpha=True, order=dorder)
        np.testing.assert_allclose(npy(model.derivs(order=dorder))[:, 0], expected, rtol=1e-8)

    def test_dxdun_ave_xalpha(self, discrete):
        u_c, w_c, _ = discrete
        abc = self._poly_cfg()
        n, d, dorder = 1, 1, 2
        b, exprs = self._xsym(abc)
        uave = sym_ensemble_avg([sp.nsimplify(v) for v in u_c], u_c, w_c, b)
        xdave = sym_ensemble_avg([sp.diff(e, b, d) for e in exprs], u_c, w_c, b)
        expr = sym_ensemble_avg(
            [(sp.diff(e, b, d) - xdave) * (sp.nsimplify(uu) - uave) ** n for e, uu in zip(exprs, u_c)],
            u_c,
            w_c,
            b,
        )
        expected = sym_derivs(expr, b, dorder)
        data = self._deriv_data(u_c, w_c, abc, n + dorder + 2, central=True)
        model = beta_xpan.factory_extrapmodel(BETA0, data, name="dxdun_ave", n=n, d=d, xalpha=True, order=dorder)
        np.testing.assert_allclose(npy(model.derivs(order=dorder))[:, 0], expected, rtol=1e-8)


class TestHighOrder:
    """Order-10 gate: the closed-form series recursions and the data layer's
    float64 weighted reduction stay exact well past the usual order 6."""

    ORDER = 10

    def test_x_ave_order10_exact(self):
        rng = np.random.default_rng(11)
        m = 6
        u_c = rng.uniform(0.5, 2.0, size=m)
        w_c = rng.uniform(0.5, 1.5, size=m)
        x_c = rng.uniform(1.0, 3.0, size=m)
        b = sp.symbols("b")
        expected = sym_derivs(sym_ensemble_avg([sp.nsimplify(v) for v in x_c], u_c, w_c, b), b, self.ORDER)
        w = boltzmann_weights(u_c, w_c)
        for central in (True, False):
            data = data_values(u_c, x_c[:, None], self.ORDER, central, w)
            got = npy(beta_xpan.factory_extrapmodel(BETA0, data).derivs())[:, 0]
            np.testing.assert_allclose(got, expected, rtol=1e-10)

"""Observable identities of the torch port, mirroring
``tests/test_identities.py``: constructions that are mathematically
identical give identical derivatives, each also held against the JAX
package on the same numpy samples; user sympy observables through
``Derivatives.from_sympy``; and the whole path samples -> moments -> series
-> prediction differentiated by autograd against finite differences.

Tolerances are the JAX test's: rtol 1e-10 for identities and the sympy
seam, 1e-9 for the lnΠ ones, gradient against central differences at rtol
1e-5; port against JAX rtol 1e-10.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import lnpi as jlnpi
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import lnpi as tlnpi

ORDER = 5
BETA0 = 1.1
RTOL = 1e-10


@pytest.fixture(scope="module")
def uval():
    return np.random.default_rng(21).normal(2.0, 0.8, 300)


@pytest.fixture(scope="module")
def xval(uval):
    return np.random.default_rng(22).normal(1.0, 0.3, uval.shape[0])


def test_xun_n0_equals_x_ave(uval, xval):
    data = tx.factory_data_values(uv=tt(uval), xv=tt(xval), order=ORDER, central=False)
    m_x = tbeta.factory_extrapmodel(BETA0, data, name="x_ave")
    m_xu0 = tbeta.factory_extrapmodel(BETA0, data, name="xun_ave", n=0, order=ORDER)
    assert_close(m_x.derivs(), m_xu0.derivs(), RTOL)
    jdata = jx.factory_data_values(uv=uval, xv=xval, order=ORDER, central=False)
    assert_close(m_xu0.derivs(), jbeta.factory_extrapmodel(BETA0, jdata, name="xun_ave", n=0, order=ORDER).derivs(), RTOL)


def test_un_n1_equals_u_ave(uval):
    data = tx.factory_data_values(uv=tt(uval), xv=None, order=ORDER + 1, central=False, x_is_u=True)
    m_u = tbeta.factory_extrapmodel(BETA0, data, name="u_ave", order=ORDER)
    m_u1 = tbeta.factory_extrapmodel(BETA0, data, name="un_ave", n=1, order=ORDER)
    assert_close(m_u.derivs(order=ORDER), m_u1.derivs(order=ORDER), RTOL)
    jdata = jx.factory_data_values(uv=uval, xv=None, order=ORDER + 1, central=False, x_is_u=True)
    jm = jbeta.factory_extrapmodel(BETA0, jdata, name="un_ave", n=1, order=ORDER)
    assert_close(m_u1.derivs(order=ORDER), jm.derivs(order=ORDER), RTOL)


@pytest.mark.parametrize("central", [False, True])
def test_lnpi_deriv_is_minus_u_ave(uval, central):
    """(lnΠ)^(k+1) = -<u>^(k) for k >= 1; first order adds mu·N."""

    def lnpi_model(pkg, xp):
        meta = pkg.lnPiDataCallback.from_mu(lnPi0=np.zeros(()), mu=[0.7], ncoords=np.ones((1,)))
        fac = tx if xp is tlnpi else jx
        data = fac.factory_data_values(uv=tt(uval) if xp is tlnpi else uval, xv=None, order=ORDER, central=central, x_is_u=True, meta=meta)
        return xp.factory_extrapmodel_lnPi(BETA0, data)

    d_lnpi = npy(lnpi_model(tlnpi, tlnpi).derivs())
    data_u = tx.factory_data_values(uv=tt(uval), xv=None, order=ORDER, central=central, x_is_u=True)
    d_u = npy(tbeta.factory_extrapmodel(BETA0, data_u, name="u_ave", order=ORDER).derivs(order=ORDER))
    np.testing.assert_allclose(d_lnpi[2:], -d_u[1:], rtol=1e-9)
    np.testing.assert_allclose(d_lnpi[1], 0.7 - d_u[0], rtol=1e-9)
    assert_close(d_lnpi, lnpi_model(jlnpi, jlnpi).derivs(), RTOL)


def test_dxdun_n1_matches_cov_derivative(uval, xval):
    """d<x>/dbeta = -<dx du>: the first x_ave derivative is minus the
    order-0 dxdun_ave(n=1) (central moments only)."""
    data = tx.factory_data_values(uv=tt(uval), xv=tt(xval), order=ORDER, central=True)
    m_x = tbeta.factory_extrapmodel(BETA0, data, name="x_ave")
    m_dxdu = tbeta.factory_extrapmodel(BETA0, data, name="dxdun_ave", n=1, order=ORDER - 2)
    np.testing.assert_allclose(npy(m_x.derivs())[1], -npy(m_dxdu.derivs(order=0))[0], rtol=RTOL)
    jdata = jx.factory_data_values(uv=uval, xv=xval, order=ORDER, central=True)
    jm = jbeta.factory_extrapmodel(BETA0, jdata, name="dxdun_ave", n=1, order=ORDER - 2)
    assert_close(m_dxdu.derivs(), jm.derivs(), RTOL)


def test_pow_post_func(uval, xval):
    from thermoextrap_tpu_torch.ops.series import series_mul

    data = tx.factory_data_values(uv=tt(uval), xv=tt(xval), order=4, central=True)
    m = tbeta.factory_extrapmodel(BETA0, data, name="x_ave")
    m_sq = tbeta.factory_extrapmodel(
        BETA0,
        data,
        name="x_ave",
        derivatives=tbeta.factory_derivatives("x_ave", central=True, post_func="pow_2"),
    )
    c = m.coefs()
    assert_close(m_sq.coefs(), series_mul(c, c, order=4), RTOL)
    jdata = jx.factory_data_values(uv=uval, xv=xval, order=4, central=True)
    jm = jbeta.factory_extrapmodel(
        BETA0, jdata, name="x_ave", derivatives=jbeta.factory_derivatives("x_ave", central=True, post_func="pow_2")
    )
    assert_close(m_sq.coefs(), jm.coefs(), RTOL)


def _sympy_x_ave(order):
    """The x_ave derivatives by symbolic truncated-series division of
    <x e^{-D u}> / <e^{-D u}>, in indexed raw moments u[n], xu[n]."""
    import sympy as sp

    u_sym, xu_sym = sp.IndexedBase("u"), sp.IndexedBase("xu")
    fact = [sp.factorial(n) for n in range(order + 1)]
    a = [(-1) ** n * xu_sym[n] / fact[n] for n in range(order + 1)]
    b = [(-1) ** n * u_sym[n] / fact[n] for n in range(order + 1)]
    c = []
    for n in range(order + 1):
        c.append(sp.expand((a[n] - sum(b[k] * c[n - k] for k in range(1, n + 1))) / b[0]))
    return [sp.expand(c[n] * fact[n]) for n in range(order + 1)], (u_sym, xu_sym)


def test_from_sympy_migration_seam(uval, xval):
    """User sympy expressions lambdified to torch reproduce the native
    engine, and the JAX package's from_sympy."""
    from thermoextrap_tpu.models.derivatives import Derivatives as JDerivatives
    from thermoextrap_tpu_torch.models.derivatives import Derivatives

    order = 4
    exprs, args = _sympy_x_ave(order)
    derivs = Derivatives.from_sympy(exprs, args=args)
    data = tx.factory_data_values(uv=tt(uval), xv=tt(xval), order=order, central=False)
    m_sympy = tx.ExtrapModel(BETA0, data, derivs, order=order)
    m_native = tbeta.factory_extrapmodel(BETA0, data, name="x_ave")
    assert_close(m_sympy.derivs(), m_native.derivs(), RTOL)
    assert_close(m_sympy.predict(1.3), m_native.predict(1.3), RTOL)
    jdata = jx.factory_data_values(uv=uval, xv=xval, order=order, central=False)
    jm = jx.ExtrapModel(BETA0, jdata, JDerivatives.from_sympy(exprs, args=args), order=order)
    assert_close(m_sympy.derivs(), jm.derivs(), RTOL)


def test_from_sympy_elementary_functions():
    """Elementary functions of the indexed symbols run on tensors."""
    import sympy as sp

    from thermoextrap_tpu_torch.models.derivatives import Derivatives

    u = sp.IndexedBase("u")
    d = Derivatives.from_sympy([sp.exp(2 * u[1]) - u[2], sp.log(u[1]) + sp.sqrt(u[2])], args=(u,))
    t = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
    got = d.coefs(args=(t,), order=1)
    want = [np.exp(1.0) - 2.0, np.log(0.5) + np.sqrt(2.0)]
    np.testing.assert_allclose(npy(got), want, rtol=1e-14)


def test_end_to_end_differentiability(uval, xval):
    """Autograd through samples -> central comoments -> series -> prediction
    matches central finite differences (the JAX test takes jax.grad)."""
    from thermoextrap_tpu_torch.models.derivatives import central_x_ave_coefs
    from thermoextrap_tpu_torch.ops.moments import reduce_central_comoments

    order, b_eval = 3, BETA0 + 0.2
    xv = tt(xval[:50])[:, None]

    def predict(u_samples):
        xave, _ua, du, dxdu = reduce_central_comoments(u_samples, xv, order)
        c = central_x_ave_coefs(xave, du[:, None], dxdu, order)
        d = b_eval - BETA0
        return sum(c[n, 0] * d**n for n in range(order + 1))

    u0 = tt(uval[:50]).requires_grad_(True)
    (g,) = torch.autograd.grad(predict(u0), u0)
    h = 1e-6
    for i in (0, 17, 42):
        up, um = uval[:50].copy(), uval[:50].copy()
        up[i] += h
        um[i] -= h
        with torch.no_grad():
            fd = (float(predict(tt(up))) - float(predict(tt(um)))) / (2 * h)
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-5, atol=1e-10)

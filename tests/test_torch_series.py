"""Parity of the torch port's moment conversions, series algebra and
derivative coefficients with the JAX package (float64, rtol 1e-12)."""

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, tt

import thermoextrap_tpu.models.derivatives as jd
import thermoextrap_tpu.ops.convert as jc
import thermoextrap_tpu.ops.series as js
import thermoextrap_tpu_torch.models.derivatives as td
import thermoextrap_tpu_torch.ops.convert as tc
import thermoextrap_tpu_torch.ops.series as ts

RTOL = 1e-12
ATOL = 1e-14


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _moments(rng, order, batch=(3,)):
    """Raw moments of random samples: u (order+1, *batch), xu (order+1, *batch, 2)."""
    u = rng.normal(1.0, 0.5, batch + (200,))
    x = rng.normal(0.5, 0.3, batch + (200, 2))
    pw = np.stack([u**n for n in range(order + 1)])
    return pw.mean(-1), (pw[..., None] * x[None]).mean(-2)


# -- ops/convert ---------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 4, 6])
def test_shift_and_central_raw(rng, order):
    u, xu = _moments(rng, order)
    delta = rng.normal(size=u.shape[1:])
    assert_close(tc.shift_raw_moments(tt(u), tt(delta)), jc.shift_raw_moments(u, delta), RTOL, ATOL)
    assert_close(
        tc.shift_raw_comoments(tt(xu), tt(delta)[:, None]),
        jc.shift_raw_comoments(xu, delta[:, None]),
        RTOL,
        ATOL,
    )
    du = jc.central_from_raw(u)
    assert_close(tc.central_from_raw(tt(u)), du, RTOL, ATOL)
    mean = u[1]
    assert_close(tc.raw_from_central(tt(du), tt(mean)), jc.raw_from_central(du, mean), RTOL, ATOL)
    ub = u[..., None]
    assert_close(tc.central_comoments_from_raw(tt(ub), tt(xu)), jc.central_comoments_from_raw(ub, xu), RTOL, ATOL)
    assert_close(tc.u_from_xu_when_x_is_u(tt(u)), jc.u_from_xu_when_x_is_u(u), RTOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_merge_central_comoments(rng, axis):
    order, nb = 4, (5, 3)
    xave = rng.normal(size=nb + (2,))
    uave = rng.normal(size=nb)
    du = np.abs(rng.normal(size=(order + 1,) + nb + (1,)))
    dxdu = rng.normal(size=(order + 1,) + nb + (2,))
    wsum = rng.uniform(1.0, 5.0, nb)
    wsum[0, 0] = 0.0  # an empty member must not poison the pool
    ref = jc.merge_central_comoments(xave, uave, du, dxdu, wsum, axis=axis)
    got = tc.merge_central_comoments(tt(xave), tt(uave), tt(du), tt(dxdu), tt(wsum), axis=axis)
    assert_close(got, ref, RTOL, ATOL)


# -- ops/series ----------------------------------------------------------------


def _series(rng, n, batch=(4,)):
    a = rng.normal(size=(n,) + batch)
    a[0] = np.abs(a[0]) + 1.0  # invertible / log-able leading term
    return a


@pytest.mark.parametrize("order", [None, 3, 7])
def test_series_mul_div_inv(rng, order):
    a, b = _series(rng, 6), _series(rng, 5)
    assert_close(ts.series_mul(tt(a), tt(b), order), js.series_mul(a, b, order), RTOL, ATOL)
    assert_close(ts.series_div(tt(a), tt(b), order), js.series_div(a, b, order), RTOL, ATOL)
    assert_close(ts.series_inv(tt(b), order), js.series_inv(b, order), RTOL, ATOL)


@pytest.mark.parametrize("power", [-2, 0, 1, 3])
def test_series_pow(rng, power):
    a = _series(rng, 6)
    assert_close(ts.series_pow(tt(a), power), js.series_pow(a, power), RTOL, ATOL)


@pytest.mark.parametrize("order", [None, 8])
def test_series_log(rng, order):
    a = _series(rng, 6)
    assert_close(ts.series_log(tt(a), order), js.series_log(a, order), RTOL, ATOL)
    assert_close(ts.series_neg_log(tt(a), order), js.series_neg_log(a, order), RTOL, ATOL)


def test_series_rescale_and_factorials(rng):
    a = _series(rng, 7)
    assert_close(ts.series_compose_linear(tt(a), 0.7), js.series_compose_linear(a, 0.7), RTOL, ATOL)
    assert_close(ts.derivs_from_coefs(tt(a)), js.derivs_from_coefs(a), RTOL, ATOL)
    assert_close(ts.coefs_from_derivs(tt(a)), js.coefs_from_derivs(a), RTOL, ATOL)


# -- models/derivatives -----------------------------------------------------------


def _central(rng, order, nd=None):
    """Central comoment arguments (x1, du, dxdu), with a deriv axis of size
    nd when given."""
    u = rng.normal(1.0, 0.5, 500)
    du_v = u - u.mean()
    du = np.stack([np.mean(du_v**n) for n in range(order + 1)])[:, None]
    xshape = (500, 2) if nd is None else (500, nd, 2)
    x = rng.normal(0.5, 0.3, xshape) + 0.2 * du_v.reshape((500,) + (1,) * (len(xshape) - 1))
    x1 = x.mean(0)
    dx = x - x1
    dxdu = np.stack([np.mean(dx * du_v.reshape(dx.shape[:1] + (1,) * (dx.ndim - 1)) ** n, 0) for n in range(order + 1)])
    return x1, du, dxdu


@pytest.mark.parametrize("order", [2, 6])
def test_central_x_ave_coefs(rng, order):
    x1, du, dxdu = _central(rng, order)
    ref = jd.central_x_ave_coefs(x1, du, dxdu, order)
    assert_close(td.central_x_ave_coefs(tt(x1), tt(du), tt(dxdu), order), ref, RTOL, ATOL)


@pytest.mark.parametrize("order", [2, 5])
def test_central_x_ave_coefs_xalpha(rng, order):
    x1, du, dxdu = _central(rng, order, nd=order + 1)
    ref = jd.central_x_ave_coefs_xalpha(x1, du[:, :, None], dxdu, order)
    got = td.central_x_ave_coefs_xalpha(tt(x1), tt(du)[:, :, None], tt(dxdu), order)
    assert_close(got, ref, RTOL, ATOL)


@pytest.mark.parametrize("order", [3, 6])
def test_raw_coefs(rng, order):
    u, xu = _moments(rng, order + 1)
    ub = u[..., None]
    assert_close(td.raw_x_ave_coefs(tt(ub), tt(xu), order), jd.raw_x_ave_coefs(ub, xu, order), RTOL, ATOL)
    assert_close(td.raw_u_ave_coefs(tt(u), order), jd.raw_u_ave_coefs(u, order), RTOL, ATOL)
    assert_close(td.un_ave_coefs(tt(u), 1, order), jd.un_ave_coefs(u, 1, order), RTOL, ATOL)
    assert_close(td.xun_ave_coefs(tt(ub), tt(xu), 1, order), jd.xun_ave_coefs(ub, xu, 1, order), RTOL, ATOL)


def test_raw_coefs_xalpha(rng):
    order = 3
    u = np.abs(rng.normal(size=(order + 1, 1, 2))) + 0.5
    u[0] = 1.0
    xu = rng.normal(size=(order + 1, order + 1, 2))
    assert_close(td.raw_x_ave_coefs_xalpha(tt(u), tt(xu), order), jd.raw_x_ave_coefs_xalpha(u, xu, order), RTOL, ATOL)
    xu2 = rng.normal(size=(2 * order + 2, order + 2, 2))
    assert_close(td.xun_ave_coefs(tt(u), tt(xu2), 1, order, d=1), jd.xun_ave_coefs(u, xu2, 1, order, d=1), RTOL, ATOL)


@pytest.mark.parametrize("n", [2, 3])
def test_central_fluctuation_coefs(rng, n):
    order = 3
    x1, du, dxdu = _central(rng, order + n)
    assert_close(td.dun_ave_coefs(tt(du), n, order), jd.dun_ave_coefs(du, n, order), RTOL, ATOL)
    assert_close(td.dxdun_ave_coefs(tt(du), tt(dxdu), n, order), jd.dxdun_ave_coefs(du, dxdu, n, order), RTOL, ATOL)
    uave = np.array(1.3)
    assert_close(td.central_u_ave_coefs(tt(uave), tt(du[:, 0]), order), jd.central_u_ave_coefs(uave, du[:, 0], order), RTOL, ATOL)


def test_dxdun_xalpha_and_lnpi(rng):
    order, n = 2, 1
    x1, du, dxdu = _central(rng, 2 * order + n + 1, nd=order + 2)
    ref = jd.dxdun_ave_coefs(du, dxdu, n, order, d=1)
    assert_close(td.dxdun_ave_coefs(tt(du), tt(dxdu), n, order, d=1), ref, RTOL, ATOL)
    c = rng.normal(size=(5, 3))
    assert_close(td.lnpi_coefs(tt(c), 0.4, 1.7, 5), jd.lnpi_coefs(c, 0.4, 1.7, 5), RTOL, ATOL)


@pytest.mark.parametrize("post", [None, "minus_log", "pow_2"])
def test_derivatives_container(rng, post):
    order = 4
    x1, du, dxdu = _central(rng, order)
    args = (x1 + 2.0, du, dxdu)
    ref = jd.Derivatives(lambda a, o: jd.central_x_ave_coefs(*a, o), post_func=post)
    got = td.Derivatives(lambda a, o: td.central_x_ave_coefs(*a, o), post_func=post)
    targs = tuple(tt(a) for a in args)
    assert_close(got.coefs(args=targs, order=order), ref.coefs(args=args, order=order), RTOL, ATOL)
    assert_close(got.derivs(args=targs, order=order, minus_log=True), ref.derivs(args=args, order=order, minus_log=True), RTOL, ATOL)
    with pytest.raises(ValueError, match="must specify"):
        got.coefs()


def test_series_autograd():
    """The port's series engine differentiates by autograd (the JAX engine
    by jax.grad): d/da0 of log(a)[1] = -a1/a0^2."""
    a = torch.tensor([2.0, 3.0, 0.5], dtype=torch.float64, requires_grad=True)
    ts.series_log(a)[1].backward()
    np.testing.assert_allclose(a.grad[0].item(), -3.0 / 4.0, rtol=RTOL)

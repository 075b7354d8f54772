r"""Analytic ideal-gas reference model: test oracle and data generator.

Counterpart of ``thermoextrap_tpu/idealgas.py``: a 1D ideal gas in a linear
external field (:math:`U = \sum_i x_i`, positions in :math:`[0, L]`), with

.. math:: \langle x\rangle = 1/\beta - L/(e^{\beta L} - 1)

and its β-derivatives from exact series division (its volume derivatives by
nested autograd).  Samples are drawn with a
``torch.Generator`` on the requested device, so the ``(R, N)`` position
block of a large run is made on the card.
"""

from __future__ import annotations

import math

import torch

from .ops.series import series_div, series_mul, series_neg_log
from .utils.random import validate_rng

__all__ = [
    "dbeta_xave",
    "dbeta_xave_depend",
    "dbeta_xave_depend_minuslog",
    "dbeta_xave_minuslog",
    "dvol_xave",
    "generate_data",
    "u_prob",
    "u_sample",
    "x_ave",
    "x_beta_extrap",
    "x_beta_extrap_depend",
    "x_beta_extrap_depend_minuslog",
    "x_beta_extrap_minuslog",
    "x_cdf",
    "x_prob",
    "x_sample",
    "x_var",
    "x_vol_extrap",
]


def _f64(v):
    return torch.as_tensor(v, dtype=torch.float64)


def x_ave(beta, vol=1.0):
    """<x> at inverse temperature beta.

    >>> round(float(x_ave(1.0)), 6)
    0.418023
    """
    beta = _f64(beta)
    return 1.0 / beta - vol / (torch.exp(beta * vol) - 1.0)


def x_var(beta, vol=1.0):
    """Var[x]."""
    beta = _f64(beta)
    e = torch.exp(beta * vol)
    return 1.0 / beta**2 - vol**2 * e / (e - 1.0) ** 2


def x_prob(x, beta, vol=1.0):
    """Probability density of one position."""
    beta = _f64(beta)
    return beta * torch.exp(-beta * _f64(x)) / (1.0 - torch.exp(-beta * vol))


def u_prob(u, npart, beta, vol=1.0):
    """Gaussian approximation of the density of ``U`` for ``npart`` particles."""
    u_ave = npart * x_ave(beta, vol)
    u_std = torch.sqrt(npart * x_var(beta, vol))
    z = (_f64(u) - u_ave) / u_std
    return torch.exp(-0.5 * z**2) / (u_std * math.sqrt(2.0 * math.pi))


def x_cdf(x, beta, vol=1.0):
    beta = _f64(beta)
    return (1.0 - torch.exp(-beta * _f64(x))) / (1.0 - torch.exp(-beta * vol))


def x_sample(shape, beta, vol=1.0, rng=None, *, device=None, dtype=torch.float64):
    """Inverse-CDF sampling of positions, drawn on ``device`` (the
    generator's device when ``rng`` is a ``torch.Generator``, else the
    package's default device when ``device`` is None)."""
    gen = validate_rng(rng, device=device)
    shape = shape if isinstance(shape, tuple) else (shape,)
    r = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    # in place: the position block is the largest tensor of a big run
    c = 1.0 - math.exp(-beta * vol)
    return r.mul_(-c).add_(1.0).log_().mul_(-1.0 / beta)


def u_sample(shape, beta, vol=1.0, rng=None, *, device=None, dtype=torch.float64):
    return x_sample(shape, beta, vol, rng, device=device, dtype=dtype).sum(dim=-1)


def generate_data(shape, beta, vol=1.0, rng=None, *, device=None, dtype=torch.float64):
    """``(x_mean_per_config, u_per_config)`` from a ``(nconfig, npart)``
    block of positions."""
    positions = x_sample(shape, beta, vol, rng, device=device, dtype=dtype)
    return positions.mean(dim=-1), positions.sum(dim=-1)


def _xave_series(beta0, vol, order: int):
    r"""Normalized Taylor coefficients of <x>(beta0 + D) to ``order``:
    ``1/beta`` has ``(-1)^n / beta0^{n+1}``; ``L/(e^{bL}-1)`` is ``L``
    series-divided by ``e^{(b0+D)L} - 1``."""
    beta0 = float(beta0)
    inv = _f64([(-1.0) ** n / beta0 ** (n + 1) for n in range(order + 1)])
    e = math.exp(beta0 * vol)
    den = _f64([e * vol**n / math.factorial(n) - (1.0 if n == 0 else 0.0) for n in range(order + 1)])
    num = torch.zeros(order + 1, dtype=torch.float64)
    num[0] = vol
    return inv - series_div(num, den, order=order)


def dbeta_xave(k: int):
    """k-th beta derivative of <x> as a callable."""

    def f(beta0, vol=1.0):
        return _xave_series(beta0, vol, k)[k] * math.factorial(k)

    return f


def _beta_series(beta0, order: int):
    """Series of the function beta itself: ``[beta0, 1, 0, ...]``."""
    c = torch.zeros(order + 1, dtype=torch.float64)
    c[0] = float(beta0)
    if order >= 1:
        c[1] = 1.0
    return c


def _dbeta(series_fn):
    """k-th beta derivative of the function whose Taylor series at beta0 is
    ``series_fn(beta0, vol, k)``, as a callable of ``(beta0, vol)``."""

    def deriv(k: int):
        def f(beta0, vol=1.0):
            return series_fn(beta0, vol, k)[k] * math.factorial(k)

        return f

    return deriv


dbeta_xave_minuslog = _dbeta(lambda b, v, k: series_neg_log(_xave_series(b, v, k)))
dbeta_xave_depend = _dbeta(lambda b, v, k: series_mul(_beta_series(b, k), _xave_series(b, v, k), order=k))
dbeta_xave_depend_minuslog = _dbeta(
    lambda b, v, k: series_neg_log(series_mul(_beta_series(b, k), _xave_series(b, v, k), order=k))
)


def dvol_xave(k: int):
    """k-th volume derivative of <x> as a callable, by nested autograd."""

    def f(beta0, vol=1.0):
        v = torch.tensor(float(vol), dtype=torch.float64, requires_grad=k > 0)
        y = x_ave(beta0, v)
        for _ in range(k):
            (y,) = torch.autograd.grad(y, v, create_graph=True)
        return y.detach()

    return f


def _taylor(derivs, da):
    """``(sum_k derivs[k] da^k / k!, derivs)``."""
    derivs = torch.stack([_f64(v) for v in derivs])
    return sum(v * da**k / math.factorial(k) for k, v in enumerate(derivs)), derivs


def _extrap(coef_fn, order, beta0, beta, vol):
    return _taylor([coef_fn(k)(beta0, vol) for k in range(order + 1)], _f64(beta) - beta0)


def x_beta_extrap(order, beta0, beta, vol=1.0):
    """Analytic Taylor extrapolation to ``order`` and its unnormalized
    coefficients: ``(prediction, derivs (order+1,))``."""
    return _extrap(dbeta_xave, order, beta0, beta, vol)


def x_beta_extrap_minuslog(order, beta0, beta, vol=1.0):
    return _extrap(dbeta_xave_minuslog, order, beta0, beta, vol)


def x_beta_extrap_depend(order, beta0, beta, vol=1.0):
    return _extrap(dbeta_xave_depend, order, beta0, beta, vol)


def x_beta_extrap_depend_minuslog(order, beta0, beta, vol=1.0):
    return _extrap(dbeta_xave_depend_minuslog, order, beta0, beta, vol)


def x_vol_extrap(order, vol0, vol, beta=1.0):
    """Analytic volume extrapolation: ``(prediction, derivs (order+1,))``."""
    return _taylor([dvol_xave(k)(beta, vol0) for k in range(order + 1)], _f64(vol) - vol0)

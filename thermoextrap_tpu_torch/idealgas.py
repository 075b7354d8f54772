r"""Analytic ideal-gas reference model: test oracle and data generator.

Counterpart of ``thermoextrap_tpu/idealgas.py``: a 1D ideal gas in a linear
external field (:math:`U = \sum_i x_i`, positions in :math:`[0, L]`), with

.. math:: \langle x\rangle = 1/\beta - L/(e^{\beta L} - 1)

and its β-derivatives from exact series division.  Samples are drawn with a
``torch.Generator`` on the requested device, so the ``(R, N)`` position
block of a large run is made on the card.
"""

from __future__ import annotations

import math

import torch

from .ops.series import series_div
from .utils.random import validate_rng

__all__ = [
    "dbeta_xave",
    "generate_data",
    "u_sample",
    "x_ave",
    "x_beta_extrap",
    "x_sample",
    "x_var",
]


def _f64(v):
    return torch.as_tensor(v, dtype=torch.float64)


def x_ave(beta, vol=1.0):
    """<x> at inverse temperature beta."""
    beta = _f64(beta)
    return 1.0 / beta - vol / (torch.exp(beta * vol) - 1.0)


def x_var(beta, vol=1.0):
    """Var[x]."""
    beta = _f64(beta)
    e = torch.exp(beta * vol)
    return 1.0 / beta**2 - vol**2 * e / (e - 1.0) ** 2


def x_sample(shape, beta, vol=1.0, rng=None, *, device=None, dtype=torch.float64):
    """Inverse-CDF sampling of positions, drawn on ``device`` (the
    generator's device when ``rng`` is a ``torch.Generator``)."""
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


def x_beta_extrap(order, beta0, beta, vol=1.0):
    """Analytic Taylor extrapolation to ``order`` and its unnormalized
    coefficients: ``(prediction, derivs (order+1,))``."""
    dbeta = _f64(beta) - beta0
    derivs = torch.stack([dbeta_xave(k)(beta0, vol) for k in range(order + 1)])
    tot = sum(v * dbeta**k / math.factorial(k) for k, v in enumerate(derivs))
    return tot, derivs

r"""Closed-form thermodynamic derivative engine on torch tensors.

Counterpart of ``thermoextrap_tpu/models/derivatives.py``.  Every observable
is the Taylor expansion in :math:`\Delta=\beta-\beta_0` of a ratio of finite
power series built from the sampled moments,

.. math::

    \langle A(\beta_0{+}\Delta)\rangle_{\beta_0+\Delta}
      = \frac{\langle A\, e^{-\Delta \delta u}\rangle}
             {\langle e^{-\Delta \delta u}\rangle},

evaluated by exact series division (:mod:`..ops.series`).  "coefs" are
Taylor coefficients ``f^(n)/n!``; "derivs" are plain derivatives ``f^(n)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from math import comb
from typing import Any, Callable

import torch

from ..ops.series import derivs_from_coefs, series_div, series_mul, series_neg_log, series_pow

__all__ = [
    "Derivatives",
    "central_u_ave_coefs",
    "central_x_ave_coefs",
    "central_x_ave_coefs_xalpha",
    "dun_ave_coefs",
    "dxdun_ave_coefs",
    "lnpi_coefs",
    "raw_u_ave_coefs",
    "raw_x_ave_coefs",
    "raw_x_ave_coefs_xalpha",
    "un_ave_coefs",
    "xun_ave_coefs",
]


def _alt(n: int) -> float:
    """(-1)^n / n!"""
    return (-1.0) ** n / math.factorial(n)


def _stack(rows):
    return torch.stack(torch.broadcast_tensors(*rows), dim=0)


def _den_series(m, order: int):
    """B[k] = (-1)^k m[k] / k! for k <= order (m = du or raw u moments)."""
    return _stack([_alt(k) * m[k] for k in range(order + 1)])


# -- <x> observables ---------------------------------------------------------


def raw_x_ave_coefs(u, xu, order: int):
    r"""Taylor coefs of <x>(b0+Delta) from raw moments u[n]=<u^n>, xu[n]=<x u^n>."""
    a = _stack([_alt(n) * xu[n] for n in range(order + 1)])
    return series_div(a, _den_series(u, order), order=order)


def raw_x_ave_coefs_xalpha(u, xu, order: int):
    r"""As :func:`raw_x_ave_coefs` with beta-dependent x: xu[n, d]=<x^{(d)} u^n>."""
    rows = [
        sum(
            (1.0 / math.factorial(d)) * _alt(m - d) * xu[m - d, d]
            for d in range(m + 1)
        )
        for m in range(order + 1)
    ]
    return series_div(_stack(rows), _den_series(u, order), order=order)


def central_x_ave_coefs(x1, du, dxdu, order: int):
    r"""Central-moment form: x1=<x>, du[n]=<du^n>, dxdu[n]=<dx du^n> (dxdu[0]=0)."""
    b = _den_series(du, order)
    a = _stack([x1 * b[n] + _alt(n) * dxdu[n] for n in range(order + 1)])
    return series_div(a, b, order=order)


def central_x_ave_coefs_xalpha(x1, du, dxdu, order: int):
    r"""Central, beta-dependent x: x1[d]=<x^{(d)}>, dxdu[n, d]=<dx^{(d)} du^n>."""
    rows = [
        sum(
            (1.0 / math.factorial(d))
            * _alt(m - d)
            * (x1[d] * du[m - d] + dxdu[m - d, d])
            for d in range(m + 1)
        )
        for m in range(order + 1)
    ]
    return series_div(_stack(rows), _den_series(du, order), order=order)


# -- <u> observables ---------------------------------------------------------


def raw_u_ave_coefs(u, order: int):
    a = _stack([_alt(n) * u[n + 1] for n in range(order + 1)])
    return series_div(a, _den_series(u, order), order=order)


def central_u_ave_coefs(uave, du, order: int):
    r"""<u>(b0+Delta) = <u>_0 + <du e^{-D du}>/<e^{-D du}>."""
    a = _stack([_alt(n) * du[n + 1] for n in range(order + 1)])
    c = series_div(a, _den_series(du, order), order=order)
    return torch.cat([(c[0] + uave)[None], c[1:]], dim=0)


# -- <u^n>, <x^{(d)} u^n> raw observables ---------------------------------------


def un_ave_coefs(u, n: int, order: int):
    a = _stack([_alt(p) * u[n + p] for p in range(order + 1)])
    return series_div(a, _den_series(u, order), order=order)


def xun_ave_coefs(u, xu, n: int, order: int, d: int | None = None):
    if d is None:
        a = _stack([_alt(m) * xu[n + m] for m in range(order + 1)])
    else:
        a = _stack(
            [
                sum(
                    (1.0 / math.factorial(j)) * _alt(m - j) * xu[n + m - j, d + j]
                    for j in range(m + 1)
                )
                for m in range(order + 1)
            ]
        )
    return series_div(a, _den_series(u, order), order=order)


# -- central fluctuation observables <du^n>, <dx^{(d)} du^n> ------------------


def _g_series(du, k: int, order: int):
    r"""G_k(Delta) = <(d0u)^k>_{b0+Delta} with the fixed shift d0u = u - <u>_{b0}."""
    a = _stack([_alt(p) * du[k + p] for p in range(order + 1)])
    return series_div(a, _den_series(du, order), order=order)


def dun_ave_coefs(du, n: int, order: int):
    r"""Taylor coefs of <(u - <u>(b))^n>(b0+Delta): with dm = G_1,
    ``<du^n>(D) = sum_k C(n,k) G_k(D) (-dm(D))^{n-k}``.  Needs du entries up
    to ``n + order``."""
    neg_g1 = -_g_series(du, 1, order)
    out = None
    for k in range(n + 1):
        gk = _g_series(du, k, order)
        term = comb(n, k) * series_mul(gk, series_pow(neg_g1, n - k, order=order), order=order)
        out = term if out is None else out + term
    return out


def _f_series(du, dxdu_col, k: int, order: int):
    r"""F_k(Delta) = <d0x (d0u)^k>_{b0+Delta} for a fixed column of dxdu."""
    a = _stack([_alt(p) * dxdu_col[k + p] for p in range(order + 1)])
    return series_div(a, _den_series(du, order), order=order)


def _dxdun_fixed_col(du, dxdu_col, n: int, order: int):
    r"""<(x - <x>(b))(u - <u>(b))^n> for a fixed (not beta-dependent) x column."""
    neg_g1 = -_g_series(du, 1, order)
    f0 = _f_series(du, dxdu_col, 0, order)
    out = None
    for k in range(n + 1):
        gk = _g_series(du, k, order)
        fk = _f_series(du, dxdu_col, k, order)
        inner = fk - series_mul(f0, gk, order=order)
        term = comb(n, k) * series_mul(inner, series_pow(neg_g1, n - k, order=order), order=order)
        out = term if out is None else out + term
    return out


def dxdun_ave_coefs(du, dxdu, n: int, order: int, d: int | None = None):
    r"""Taylor coefs of <dx^{(d)}(b) du(b)^n>(b0+Delta); a beta-dependent x
    (``d`` given) adds a Cauchy convolution over the deriv index."""
    if d is None:
        return _dxdun_fixed_col(du, dxdu, n, order)
    cols = {d + j: _dxdun_fixed_col(du, dxdu[:, d + j], n, order - j) for j in range(order + 1)}
    rows = [
        sum((1.0 / math.factorial(j)) * cols[d + j][m - j] for j in range(m + 1))
        for m in range(order + 1)
    ]
    return _stack(rows)


def lnpi_coefs(u_ave_c, lnpi0, mudotn, order: int):
    r"""Taylor coefs of lnPi(b0+Delta) from the coefs of <u>(b0+Delta):
    ``c[0] = lnPi0``, ``c[m] = (mudotN delta_{m,1} - u_ave_c[m-1]) / m``."""
    rows = [torch.as_tensor(lnpi0, dtype=u_ave_c.dtype, device=u_ave_c.device) + 0.0 * u_ave_c[0]]
    for m in range(1, order + 1):
        val = -u_ave_c[m - 1] / m
        if m == 1:
            val = val + mudotn
        rows.append(val)
    return _stack(rows)


# -- Derivatives container ------------------------------------------------------


@dataclass(frozen=True)
class Derivatives:
    """A coefficient function computing all derivatives to a given order.

    ``coefs_fn(args, order) -> (order+1, ...)`` gives normalized Taylor
    coefficients from a data object's ``derivs_args``; ``post_func`` is
    ``None``, ``"minus_log"``, ``"pow_<i>"`` or a callable applied to the
    coefficient series.
    """

    coefs_fn: Callable[[tuple, int], Any]
    name: str = "custom"
    post_func: Any = None

    def _apply_post(self, c):
        pf = self.post_func
        if pf is None:
            return c
        if callable(pf):
            return pf(c)
        if pf == "minus_log":
            return series_neg_log(c)
        if isinstance(pf, str) and pf.startswith("pow_"):
            return series_pow(c, int(pf.split("_")[-1]), order=c.shape[0] - 1)
        msg = f"unknown post_func {pf!r}"
        raise ValueError(msg)

    def coefs(self, data=None, args=None, order=None, minus_log=False):
        """Normalized Taylor coefficients ``f^(n)/n!``, stacked on axis 0."""
        if data is not None:
            args = data.derivs_args
            if order is None:
                order = data.order
        if args is None or order is None:
            msg = "must specify (args and order) or data"
            raise ValueError(msg)
        c = self._apply_post(self.coefs_fn(tuple(args), int(order)))
        return series_neg_log(c) if minus_log else c

    def derivs(self, data=None, args=None, order=None, minus_log=False, norm=False):
        """Plain derivatives ``f^(n)`` (or coefficients if ``norm=True``)."""
        c = self.coefs(data=data, args=args, order=order, minus_log=minus_log)
        return c if norm else derivs_from_coefs(c)

    @classmethod
    def from_funcs(cls, funcs, name="custom"):
        """Build from an indexable of per-order derivative functions."""

        def coefs_fn(args, order):
            return _stack([funcs[i](*args) / math.factorial(i) for i in range(order + 1)])

        return cls(coefs_fn=coefs_fn, name=name)

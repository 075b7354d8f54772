"""Plain float64 moments and truncated Taylor series of thermodynamic
extrapolation, written from the theory and not from the program.

For samples at inverse temperature ``beta0`` and ``D = beta - beta0``,

    <x>(beta) = <x e^{-D u}> / <e^{-D u}>
              = <x> + <dx e^{-D du}> / <e^{-D du}>,

with ``du = u - <u>`` and ``dx = x - <x>``.  Expanding both averages in
``D`` gives ``a_n = (-1)^n/n! <dx du^n>`` and ``b_n = (-1)^n/n! <du^n>``,
and the Taylor coefficients of ``<x>`` are ``<x> e_0 + a / b`` as power
series.  ``<u>(beta)`` is the same with ``x = u``.  For a macrostate
distribution ``d lnPi(N)/d beta = mu N - <u>_N``, so ``lnPi`` takes ``c_0 =
lnPi0`` and ``c_m = (mu N [m = 1] - <u>_m-1) / m``.

Every function works on the leading (order) axis and broadcasts the rest.
"""

from __future__ import annotations

import math

import torch


def alt(n: int) -> float:
    """(-1)^n / n!"""
    return (-1.0) ** n / math.factorial(n)


def series_div(a, b):
    """``c = a / b`` as power series truncated at ``a``'s length."""
    c = []
    for k in range(a.shape[0]):
        acc = a[k]
        for i in range(1, k + 1):
            acc = acc - b[i] * c[k - i]
        c.append(acc / b[0])
    return torch.stack(c)


def central(sums_u, sums_x, order: int):
    """Central (co)moments from weighted power sums about a fixed shift.

    ``sums_u[..., k] = sum_j w_j (u_j - s)^k`` and, when given,
    ``sums_x[..., k] = sum_j w_j (x_j - s_x)(u_j - s)^k``, ``k = 0 ..
    order``.  Returns ``(du_off, du, dx_off, dxdu)``: the mean of ``u``
    less ``s``, ``du[n] = <(u - <u>)^n>`` on the leading axis, and for ``x``
    its mean less ``s_x`` and ``dxdu[n] = <(x - <x>)(u - <u>)^n>`` (None
    without ``sums_x``)."""
    w = sums_u[..., 0]
    m = sums_u / w[..., None]
    d = m[..., 1]
    du = torch.stack(
        [sum(math.comb(n, k) * m[..., k] * (-d) ** (n - k) for k in range(n + 1)) for n in range(order + 1)]
    )
    if sums_x is None:
        return d, du, None, None
    t = sums_x / w[..., None]
    dx_off = t[..., 0]
    xu = torch.stack(
        [sum(math.comb(n, k) * t[..., k] * (-d) ** (n - k) for k in range(n + 1)) for n in range(order + 1)]
    )
    return d, du, dx_off, xu - dx_off[None] * du


def x_ave_coefs(xbar, du, dxdu, order: int):
    """Taylor coefficients of <x>(beta0 + D)."""
    a = torch.stack([alt(n) * dxdu[n] for n in range(order + 1)])
    b = torch.stack([alt(n) * du[n] for n in range(order + 1)])
    c = series_div(a, b)
    return torch.cat([(c[0] + xbar)[None], c[1:]])


def u_ave_coefs(ubar, du, order: int):
    """Taylor coefficients of <u>(beta0 + D); ``du`` runs to ``order + 1``."""
    a = torch.stack([alt(n) * du[n + 1] for n in range(order + 1)])
    b = torch.stack([alt(n) * du[n] for n in range(order + 1)])
    c = series_div(a, b)
    return torch.cat([(c[0] + ubar)[None], c[1:]])


def lnpi_coefs(u_coefs, lnpi0, mudotn, order: int):
    """Taylor coefficients of lnPi(beta0 + D) from those of <u> (to
    ``order - 1``)."""
    rows = [lnpi0 + 0.0 * u_coefs[0]]
    for m in range(1, order + 1):
        rows.append((mudotn if m == 1 else 0.0) - u_coefs[m - 1] / m)
    return torch.stack(rows)


def poly_eval(coefs, dbeta):
    """``sum_m coefs[m] D^m`` for each ``D`` of ``dbeta (A,)``: ``(A,
    *coefs.shape[1:])``."""
    powers = torch.stack([dbeta**m for m in range(coefs.shape[0])], dim=-1)  # (A, order+1)
    return torch.tensordot(powers, coefs, dims=([1], [0]))

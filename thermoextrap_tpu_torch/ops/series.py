r"""Truncated Taylor-series (jet) algebra on torch tensors.

Counterpart of ``thermoextrap_tpu/ops/series.py``.  A series is a tensor
``c`` whose leading axis of length ``K+1`` holds the *normalized* Taylor
coefficients ``c[n] = f^(n)(0) / n!``; the remaining axes are batch axes
(bootstrap replicates, observable components, ...) and broadcast
elementwise.  All recursions are O(order^2) loops over the static order.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "coefs_from_derivs",
    "derivs_from_coefs",
    "series_compose_linear",
    "series_div",
    "series_inv",
    "series_log",
    "series_mul",
    "series_neg_log",
    "series_pow",
]


def _sum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _stack(rows):
    return torch.stack(torch.broadcast_tensors(*rows), dim=0)


def _zeros_like_row(a):
    return torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)


def _unit(like, order: int):
    """The series ``1`` with ``like``'s batch shape."""
    one = torch.zeros((order + 1,) + tuple(like.shape[1:]), dtype=like.dtype, device=like.device)
    one[0] = 1.0
    return one


def series_mul(a, b, order: int | None = None):
    """Cauchy product ``c[n] = sum_k a[k] b[n-k]``, truncated at ``order``.

    >>> [float(c) for c in series_mul(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 1.0, 1.0]))]
    [1.0, 3.0, 3.0, 2.0]
    """
    ka, kb = a.shape[0] - 1, b.shape[0] - 1
    if order is None:
        order = ka + kb
    out = []
    for n in range(order + 1):
        terms = [a[k] * b[n - k] for k in range(max(0, n - kb), min(n, ka) + 1)]
        if terms:
            out.append(_sum(terms))
        else:
            shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
            out.append(torch.zeros(shape, dtype=a.dtype, device=a.device))
    return _stack(out)


def series_div(a, b, order: int | None = None):
    """Series division ``c = a / b``: ``c[n] = (a[n] - sum_{k>=1} b[k] c[n-k]) / b[0]``."""
    if order is None:
        order = a.shape[0] - 1
    kb = b.shape[0] - 1
    inv_b0 = 1.0 / b[0]
    cs = []
    for n in range(order + 1):
        an = a[n] if n < a.shape[0] else _zeros_like_row(a)
        terms = [b[k] * cs[n - k] for k in range(1, min(n, kb) + 1)]
        num = an - _sum(terms) if terms else an
        cs.append(num * inv_b0)
    return _stack(cs)


def series_inv(b, order: int | None = None):
    """Series reciprocal ``1 / b``."""
    if order is None:
        order = b.shape[0] - 1
    return series_div(_unit(b, order), b, order=order)


def series_pow(a, i: int, order: int | None = None):
    """Integer power ``a**i`` by repeated squaring on series."""
    if order is None:
        order = a.shape[0] - 1
    if i < 0:
        return series_inv(series_pow(a, -i, order=order), order=order)
    result = _unit(a, order)
    base = a
    n = i
    while n:
        if n & 1:
            result = series_mul(result, base, order=order)
        n >>= 1
        if n:
            base = series_mul(base, base, order=order)
    return result


def series_log(a, order: int | None = None):
    r"""Series logarithm: ``g = log(a)`` from ``a g' = a'``, i.e.
    ``n g[n] = n a[n]/a[0] - sum_{k=1}^{n-1} k g[k] a[n-k] / a[0]``."""
    if order is None:
        order = a.shape[0] - 1
    inv_a0 = 1.0 / a[0]
    gs = [torch.log(a[0])]
    for n in range(1, order + 1):
        an = a[n] if n < a.shape[0] else _zeros_like_row(a)
        terms = [(k / n) * gs[k] * a[n - k] for k in range(1, n) if n - k < a.shape[0]]
        num = an - _sum(terms) if terms else an
        gs.append(num * inv_a0)
    return _stack(gs)


def series_neg_log(a, order: int | None = None):
    """``-log(a)`` as a series."""
    return -series_log(a, order=order)


def series_compose_linear(a, scale):
    """Compose a series with ``Delta -> scale * Delta`` (coefficient rescale)."""
    factors = torch.tensor([scale**n for n in range(a.shape[0])], dtype=a.dtype, device=a.device)
    return a * factors.reshape((-1,) + (1,) * (a.ndim - 1))


def derivs_from_coefs(c):
    """Normalized Taylor coefficients to derivatives: ``f^(n) = n! c[n]``."""
    facts = torch.tensor(
        [math.factorial(n) for n in range(c.shape[0])], dtype=c.dtype, device=c.device
    )
    return c * facts.reshape((-1,) + (1,) * (c.ndim - 1))


def coefs_from_derivs(d):
    """Inverse of :func:`derivs_from_coefs`."""
    facts = torch.tensor(
        [1.0 / math.factorial(n) for n in range(d.shape[0])], dtype=d.dtype, device=d.device
    )
    return d * facts.reshape((-1,) + (1,) * (d.ndim - 1))

r"""Moment-type conversions (raw ↔ central, shifted raw) as closed-form
binomial transforms, on torch tensors.

Counterpart of ``thermoextrap_tpu/ops/convert.py``.  Layout convention:
moment arrays carry the moment order on the *leading* axis, ``m[n] =``
``n``-th moment, with arbitrary broadcastable batch axes behind.  Every
function is out-of-place, so autograd flows through it.
"""

from __future__ import annotations

from math import comb

import torch

__all__ = [
    "central_comoments_from_raw",
    "central_from_raw",
    "fix_central_du",
    "fix_central_dxdu",
    "merge_central_comoments",
    "raw_from_central",
    "shift_raw_comoments",
    "shift_raw_moments",
    "u_from_xu_when_x_is_u",
]


def _powers(base, order: int):
    """[base**0, ..., base**order] as a list."""
    out = [torch.ones_like(base)]
    for _ in range(order):
        out.append(out[-1] * base)
    return out


def _binomial_shift(m, base):
    """``out[n] = sum_k C(n,k) m[k] base^{n-k}`` for n = 0..order; ``base``
    a tensor or a Python number (taken in ``m``'s dtype and device)."""
    if not isinstance(base, torch.Tensor):
        base = torch.as_tensor(base, dtype=m.dtype, device=m.device)
    order = m.shape[0] - 1
    d = _powers(base, order)
    rows = [
        sum(comb(n, k) * m[k] * d[n - k] for k in range(n + 1))
        for n in range(order + 1)
    ]
    return torch.stack(torch.broadcast_tensors(*rows), dim=0)


def fix_central_du(du):
    """``du`` with the exact ``du[0] = 1, du[1] = 0`` convention."""
    head = [torch.ones_like(du[:1])]
    if du.shape[0] > 1:
        head.append(torch.zeros_like(du[1:2]))
    return torch.cat(head + [du[2:]], dim=0)


def fix_central_dxdu(dxdu):
    """``dxdu`` with the exact ``dxdu[0] = 0`` convention."""
    return torch.cat([torch.zeros_like(dxdu[:1]), dxdu[1:]], dim=0)


def shift_raw_moments(u, delta):
    r"""Shift raw moments: given ``u[k] = <(y)^k>`` return ``<(y - delta)^n>``,
    ``out[n] = sum_k C(n,k) u[k] (-delta)^{n-k}``."""
    return _binomial_shift(u, -delta)


def shift_raw_comoments(xu, delta):
    r"""Shift the u-argument of raw comoments ``xu[k] = <x y^k>`` by ``delta``;
    the same binomial transform as :func:`shift_raw_moments` (the x factor
    rides along)."""
    return shift_raw_moments(xu, delta)


def central_from_raw(u):
    r"""Raw → central moments of ``u``: ``u[k] = <u^k>`` → ``du[n] =``
    ``<(u - <u>)^n>`` with ``du[0]=1`` and ``du[1]=0`` exactly."""
    return fix_central_du(shift_raw_moments(u, u[1]))


def raw_from_central(du, mean):
    r"""Central → raw: ``u[n] = sum_k C(n,k) du[k] mean^{n-k}``."""
    return _binomial_shift(du, mean)


def central_comoments_from_raw(u, xu):
    r"""Raw comoments → central comoments ``(xave, du, dxdu)`` with
    ``dxdu[n] = <(x - <x>)(u - <u>)^n>`` and ``dxdu[0] = 0`` exactly."""
    xave = xu[0]
    du = central_from_raw(u)
    x_du = shift_raw_comoments(xu, u[1])
    du_full = shift_raw_moments(u, u[1])
    return xave, du, fix_central_dxdu(x_du - xave * du_full)


def u_from_xu_when_x_is_u(xu, fill0=1.0):
    r"""The ``x_is_u`` shift trick: when ``x == u``, ``xu[n] = u[n+1]``, so
    ``u`` is ``xu`` shifted up one moment with ``u[0] = fill0``."""
    return torch.cat([torch.full_like(xu[:1], fill0), xu], dim=0)


def _pad_trailing(a, ndim: int):
    """Append singleton axes until ``a.ndim == ndim``."""
    return a.reshape(a.shape + (1,) * (ndim - a.ndim)) if a.ndim < ndim else a


def merge_central_comoments(xave, uave, du, dxdu, wsum, axis: int = 0):
    r"""Merge independent central comoment sets along ONE batch axis,
    keeping the other batch axes: every set's moments are shifted about the
    pooled means, then averaged with their weights.  Zero-weight members
    contribute nothing (masked, not multiplied, so an ``inf``/``NaN`` state
    of an empty member cannot poison the pool).

    Shapes (axis 0 after normalization): ``xave (B, *b, *val)``,
    ``uave (B, *b)``, ``du (order+1, B, *b, 1...)``,
    ``dxdu (order+1, B, *b, *val)``, ``wsum (B, *b)``.  Returns the same
    tuple with the merged axis reduced away.
    """
    axis = int(axis) % max(uave.ndim, 1)
    uave = torch.movedim(uave, axis, 0)
    wsum = torch.movedim(wsum, axis, 0)
    xave = torch.movedim(xave, axis, 0)
    dxdu = torch.movedim(dxdu, axis + 1, 1)
    du = _pad_trailing(torch.movedim(du, axis + 1, 1), dxdu.ndim)

    order = du.shape[0] - 1
    wtot = wsum.sum(dim=0)
    w = wsum / wtot
    pos = w > 0
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w_m = torch.where(pos, w, zero)
    u_pool = torch.where(pos, w * uave, zero).sum(dim=0)
    w_x = _pad_trailing(w_m, xave.ndim)
    x_pool = torch.where(w_x > 0, w_x * xave, zero).sum(dim=0)

    delta_u = uave - u_pool
    shifted_u = raw_from_central(du, _pad_trailing(delta_u, du.ndim - 1))

    dxb = xave - x_pool
    base = dxdu + dxb[None] * du
    d = _powers(_pad_trailing(delta_u, dxdu.ndim - 1), order)
    rows = [
        sum(comb(n, k) * base[k] * d[n - k] for k in range(n + 1))
        for n in range(order + 1)
    ]
    shifted_xu = torch.stack(torch.broadcast_tensors(*rows), dim=0)

    w_u = _pad_trailing(w_m, shifted_u.ndim - 1)
    w_xu = _pad_trailing(w_m, shifted_xu.ndim - 1)
    du_m = torch.where(w_u > 0, w_u * shifted_u, zero).sum(dim=1)
    dxdu_m = torch.where(w_xu > 0, w_xu * shifted_xu, zero).sum(dim=1)
    return x_pool, u_pool, fix_central_du(du_m), fix_central_dxdu(dxdu_m), wtot

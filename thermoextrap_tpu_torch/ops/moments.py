r"""Weighted (co)moment reduction over the sample axis, in plain torch.

Counterpart of ``thermoextrap_tpu/ops/moments.py``: the two-pass central
reduction (means first, then moments of the exactly centred samples) and
the raw reduction.  This is the float64 path that CPU tensors take, and the
oracle the kernels are held against.

Layouts: ``uv (*batch, R)``, ``xv (*batch, R, *val)``, ``weight``
broadcastable to ``uv`` or ``None``; moment arrays carry the moment order on
the leading axis (``u: (order+1, *batch)``, ``xu: (order+1, *batch, *val)``).
"""

from __future__ import annotations

import torch

from .convert import fix_central_du, fix_central_dxdu

__all__ = [
    "reduce_central_comoments",
    "reduce_raw_comoments",
    "u_power_stack",
]


def u_power_stack(uv, order: int):
    """Stack ``[u^0, ..., u^order]`` on a new trailing axis: ``(*batch, R, order+1)``."""
    out = [torch.ones_like(uv)]
    for _ in range(order):
        out.append(out[-1] * uv)
    return torch.stack(out, dim=-1)


def _normalize_weight(uv, weight):
    if weight is None:
        return torch.ones_like(uv)
    w = torch.as_tensor(weight, dtype=uv.dtype, device=uv.device)
    return torch.broadcast_to(w, uv.shape)


def _split_shapes(uv, xv, val_ndim: int):
    batch = tuple(uv.shape[:-1])
    val_shape = tuple(xv.shape[len(batch) + 1 :])
    if val_ndim != len(val_shape):
        msg = f"{val_ndim=} inconsistent with xv shape {tuple(xv.shape)} and batch {batch}"
        raise ValueError(msg)
    return batch, val_shape


def reduce_raw_comoments(uv, xv, order: int, weight=None, val_ndim: int = 1):
    r"""Raw comoments ``(u, xu)``: ``u[n] = <w u^n>/<w>`` with shape
    ``(order+1, *batch)`` and ``xu[n] = <w x u^n>/<w>`` with shape
    ``(order+1, *batch, *val)``."""
    w = _normalize_weight(uv, weight)
    batch, val_shape = _split_shapes(uv, xv, val_ndim)
    nrec = uv.shape[-1]
    wsum = w.sum(dim=-1)
    powers = u_power_stack(uv, order) * w[..., None]
    u = powers.sum(dim=-2) / wsum[..., None]
    xflat = xv.reshape(batch + (nrec, -1))
    xu = torch.einsum("...rn,...rv->...nv", powers, xflat) / wsum[..., None, None]
    xu = xu.reshape(batch + (order + 1,) + val_shape)
    return torch.movedim(u, -1, 0), torch.movedim(xu, len(batch), 0)


def reduce_central_comoments(uv, xv, order: int, weight=None, val_ndim: int = 1):
    r"""Two-pass central comoments ``(xave, uave, du, dxdu)``:

    - ``xave = <w x>/<w>``, shape ``(*batch, *val)``
    - ``uave = <w u>/<w>``, shape ``(*batch,)``
    - ``du[n] = <w (u-uave)^n>/<w>``, shape ``(order+1, *batch)``, with
      ``du[0]=1, du[1]=0`` exactly
    - ``dxdu[n] = <w (x-xave)(u-uave)^n>/<w>``, shape
      ``(order+1, *batch, *val)``, with ``dxdu[0]=0`` exactly
    """
    w = _normalize_weight(uv, weight)
    batch, val_shape = _split_shapes(uv, xv, val_ndim)
    nrec = uv.shape[-1]
    wsum = w.sum(dim=-1)
    uave = (w * uv).sum(dim=-1) / wsum
    xflat = xv.reshape(batch + (nrec, -1))
    xave = (w[..., None] * xflat).sum(dim=-2) / wsum[..., None]

    powers = u_power_stack(uv - uave[..., None], order) * w[..., None]
    du = powers.sum(dim=-2) / wsum[..., None]
    dx = xflat - xave[..., None, :]
    dxdu = torch.einsum("...rn,...rv->...nv", powers, dx) / wsum[..., None, None]

    nb = len(batch)
    du = fix_central_du(torch.movedim(du, -1, 0))
    dxdu = fix_central_dxdu(torch.movedim(dxdu, nb, 0))
    return (
        xave.reshape(batch + val_shape),
        uave,
        du,
        dxdu.reshape((order + 1,) + batch + val_shape),
    )

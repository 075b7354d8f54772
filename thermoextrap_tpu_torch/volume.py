r"""Volume extrapolation (first order).

Counterpart of ``thermoextrap_tpu/volume.py``.  ``W`` (held in the data's
``uv`` slot) is the temperature-scaled virial :math:`\beta \mathcal{W}`; only
first-order volume derivatives are defined (higher orders would need force
derivatives):

.. math::

    \frac{d\langle x\rangle}{dV}
      = \frac{-\langle x\rangle\langle W\rangle + \langle x W\rangle
              + \langle \textstyle\sum_i \partial x/\partial q_i\, q_i\rangle}
             {V\, d}
"""

from __future__ import annotations

import dataclasses

import torch

from .data import DataCallbackABC, DataValues, _as_tensor
from .models.derivatives import Derivatives
from .models.extrap import ExtrapModel
from .ops.resample import resample_values

__all__ = ["VolumeDataCallback", "VolumeDerivFuncs", "factory_derivatives", "factory_extrapmodel"]


class VolumeDerivFuncs:
    """Indexable derivative functions of the volume expansion."""

    def __getitem__(self, order: int):
        if order > 1:
            msg = (
                f"Volume derivatives cannot go past 1st order (received {order}); "
                "would need derivatives of forces"
            )
            raise ValueError(msg)
        return self.create_deriv_func(order)

    @staticmethod
    def create_deriv_func(order: int):
        def func(w, xw, dxdq, volume, ndim=1):
            # w: raw moments of W = beta * virial; xw: raw comoments <x W^n>
            if order == 0:
                return xw[0]
            return (-xw[0] * w[1] + xw[1] + dxdq) / (volume * ndim)

        return func


def factory_derivatives() -> Derivatives:
    """Derivatives object of the volume expansion."""
    return Derivatives.from_funcs(VolumeDerivFuncs(), name="volume")


@dataclasses.dataclass(frozen=True, eq=False)
class VolumeDataCallback(DataCallbackABC):
    """Carries ``(volume, dxdqv, ndim)`` and appends ``(dxdq mean, volume,
    ndim)`` to ``derivs_args``."""

    volume: torch.Tensor
    dxdqv: torch.Tensor  # (rec, *val) samples of sum_i dx/dq_i q_i
    ndim: int

    def dxdq(self, nbatch: int = 0, weight=None):
        if weight is None:
            return self.dxdqv.mean(dim=nbatch)
        # weighted data weights every stream alike (the serving pipeline
        # packs dxdqv into the same weighted reduction as x)
        w = torch.as_tensor(weight, dtype=self.dxdqv.dtype, device=self.dxdqv.device)
        w = w.reshape(w.shape + (1,) * (self.dxdqv.ndim - w.ndim))
        return (w * self.dxdqv).sum(dim=nbatch) / w.sum()

    def resample(self, data, *, indices=None, freq=None, **kws):
        if indices is None:
            msg = "volume callback resampling requires index-style sampler"
            raise NotImplementedError(msg)
        return dataclasses.replace(self, dxdqv=resample_values(self.dxdqv, indices, rec_axis=0))

    def derivs_args(self, data, derivs_args):
        return (
            *tuple(derivs_args),
            self.dxdq(nbatch=getattr(data, "nbatch", 0), weight=getattr(data, "weight", None)),
            self.volume,
            self.ndim,
        )


def factory_extrapmodel(
    volume: float,
    uv,
    xv,
    dxdqv,
    *,
    ndim: int = 3,
    order: int = 1,
    alpha_name: str = "volume",
    **kws,
) -> ExtrapModel:
    """ExtrapModel of the volume expansion.  ``uv`` must be the
    temperature-scaled virial ``beta * virial``; ``dxdqv`` holds samples of
    ``sum_i dx/dq_i q_i``."""
    if order != 1:
        msg = "only order=1 is supported"
        raise ValueError(msg)
    uv = _as_tensor(uv)
    meta = VolumeDataCallback(
        volume=torch.tensor(float(volume), dtype=torch.float64, device=uv.device),
        dxdqv=_as_tensor(dxdqv, uv.device),
        ndim=int(ndim),
    )
    data = DataValues.from_vals(xv, uv, order=order, central=False, meta=meta, **kws)
    return ExtrapModel(
        alpha0=volume,
        data=data,
        derivatives=factory_derivatives(),
        order=order,
        minus_log=False,
        alpha_name=alpha_name,
    )

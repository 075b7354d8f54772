r"""Volume expansion specialized to the 1D ideal gas.

Counterpart of ``thermoextrap_tpu/volume_idealgas.py``.  Differs from
:mod:`.volume` by the observable-specific correction term ``<x>/L`` (for the
ideal-gas mean position) in place of the general ``dxdq`` data term, and by
dropping the ``ndim`` factor (1D).
"""

from __future__ import annotations

from .data import factory_data_values
from .models.derivatives import Derivatives
from .models.extrap import ExtrapModel

__all__ = [
    "VolumeDerivFuncsIG",
    "factory_derivatives",
    "factory_extrapmodel",
    "factory_extrapmodel_data",
]


class VolumeDerivFuncsIG:
    """Indexable ideal-gas volume-derivative functions."""

    def __init__(self, refV: float = 1.0) -> None:  # noqa: N803
        self.refV = refV

    def __getitem__(self, order: int):
        if order > 1:
            msg = f"Volume derivatives cannot go past 1st order (received {order})"
            raise ValueError(msg)
        return self.create_deriv_func(order)

    def create_deriv_func(self, order: int):
        def func(w, xw):
            if order == 0:
                return xw[0]
            # (xW[1] - xW[0] W[1]) / refV  +  <x>/L (the ideal-gas term)
            return (xw[1] - xw[0] * w[1]) / self.refV + xw[0] / self.refV

        return func


def factory_derivatives(refV: float = 1.0) -> Derivatives:  # noqa: N803
    return Derivatives.from_funcs(VolumeDerivFuncsIG(refV=refV), name="volume_ig")


def factory_extrapmodel(volume: float, uv, xv, order: int = 1, alpha_name: str = "volume", **kws) -> ExtrapModel:
    """ExtrapModel of the ideal-gas volume expansion; ``uv`` = ``beta *
    virial``."""
    if order != 1:
        msg = "only first order supported"
        raise ValueError(msg)
    data = factory_data_values(uv=uv, xv=xv, order=order, central=False, xalpha=False, **kws)
    return ExtrapModel(
        alpha0=volume,
        data=data,
        derivatives=factory_derivatives(refV=volume),
        order=order,
        minus_log=False,
        alpha_name=alpha_name,
    )


def factory_extrapmodel_data(volume: float, data, order: int | None = 1, alpha_name: str = "volume") -> ExtrapModel:
    """ExtrapModel of the ideal-gas volume expansion from a pre-built data
    object, which must carry raw moments (``central=False``) with no
    explicit alpha dependence."""
    if order is None:
        order = data.order
    if order != 1:
        msg = "only first order supported"
        raise ValueError(msg)
    if order > data.order:
        msg = f"{order=} exceeds data.order={data.order}"
        raise ValueError(msg)
    if data.central:
        msg = "only works with raw moments"
        raise ValueError(msg)
    if data.xalpha:
        msg = "explicit alpha dependence not supported"
        raise ValueError(msg)
    return ExtrapModel(
        alpha0=volume,
        data=data,
        derivatives=factory_derivatives(refV=volume),
        order=order,
        minus_log=False,
        alpha_name=alpha_name,
    )

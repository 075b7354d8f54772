r"""Inverse-temperature expansion of the macrostate distribution lnΠ.

Counterpart of ``thermoextrap_tpu/lnpi.py``.  For the grand-canonical
macrostate distribution :math:`\ln\Pi(N)`,

.. math:: \frac{d \ln\Pi}{d\beta} = \mu\!\cdot\!N - \langle u\rangle_N

(terms independent of N dropped), so order-:math:`m` derivatives of lnΠ are
order-:math:`m-1` derivatives of :math:`\langle u\rangle`: the engine
integrates the ``u_ave`` series once (:func:`.models.derivatives.lnpi_coefs`).

The macrostate grid lives in the batch axes of the data (``uv (*n_grid,
rec)`` with ``x_is_u=True``), so one reduction gives the energy moments of
every macrostate (K4 on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from .data import DataCallbackABC, _as_tensor
from .models.derivatives import Derivatives, central_u_ave_coefs, lnpi_coefs, raw_u_ave_coefs
from .models.extrap import ExtrapModel

__all__ = ["factory_derivatives", "factory_extrapmodel_lnPi", "lnPiDataCallback"]


def _lnpi_coefs_fn(central: bool):
    def coefs_fn(args, order):
        *uargs, lnpi0, mudotn = args
        if order == 0:
            zero = torch.zeros((1, *lnpi0.shape), dtype=torch.float64, device=lnpi0.device)
            return lnpi_coefs(zero, lnpi0, mudotn, order)
        if central:
            u_c = central_u_ave_coefs(*uargs, order - 1)
        else:
            u_c = raw_u_ave_coefs(*uargs, order - 1)
        return lnpi_coefs(u_c, lnpi0, mudotn, order)

    return coefs_fn


def factory_derivatives(name: str = "lnPi", *, central: bool = False, post_func=None, **kws) -> Derivatives:
    """Derivatives of lnΠ; other names go to the β factory."""
    if name == "lnPi":
        return Derivatives(coefs_fn=_lnpi_coefs_fn(bool(central)), name="lnPi", post_func=post_func)
    from . import beta

    return beta.factory_derivatives(name=name, central=central, post_func=post_func, **kws)


@dataclasses.dataclass(frozen=True, eq=False)
class lnPiDataCallback(DataCallbackABC):  # noqa: N801 - the reference's name
    """Metadata callback carrying ``(lnPi0, mudotN)``.

    ``lnPi0``: the macrostate distribution at the reference β over the N
    grid; ``mudotN``: :math:`\\mu \\cdot N` per macrostate.  Both are handed
    to the engine on the device of the moments.
    """

    lnPi0: torch.Tensor
    mudotN: torch.Tensor
    allow_resample: bool = False

    @classmethod
    def from_mu(cls, lnPi0, mu, ncoords, *, comp_axis: int = 0, allow_resample: bool = False):  # noqa: N803
        """Build from chemical potential(s) ``mu (ncomp,)`` and particle
        numbers ``ncoords (ncomp, *n_grid)``."""
        lnPi0 = _as_tensor(lnPi0)  # noqa: N806
        mu = torch.atleast_1d(_as_tensor(mu, lnPi0.device))
        ncoords = _as_tensor(ncoords, lnPi0.device)
        mudotn = torch.tensordot(mu.to(ncoords.dtype), ncoords, dims=([0], [comp_axis]))
        return cls(lnPi0=lnPi0, mudotN=mudotn, allow_resample=bool(allow_resample))

    def resample(self, data, **kws):
        if not self.allow_resample:
            msg = (
                "Set allow_resample=True to resample lnPi0 (ad hoc; resampling "
                "the collection matrices is the recommended route)"
            )
            raise ValueError(msg)
        return self

    def derivs_args(self, data, derivs_args):
        device = derivs_args[0].device
        return (*tuple(derivs_args), self.lnPi0.to(device), self.mudotN.to(device))


def factory_extrapmodel_lnPi(  # noqa: N802 - the reference's name
    beta: float,
    data,
    *,
    central: bool | None = None,
    order: int | None = None,
    alpha_name: str = "beta",
    derivatives: Derivatives | None = None,
    post_func=None,
) -> ExtrapModel:
    """ExtrapModel of the β expansion of lnΠ.  ``order`` defaults to
    ``data.order + 1``: lnΠ' = μN − ⟨u⟩ uses one moment order less than a
    direct observable."""
    if central is None:
        central = data.central
    if order is None:
        order = data.order + 1
    if central != data.central:
        msg = f"{central=} != {data.central=}"
        raise ValueError(msg)
    if order > data.order + 1:
        msg = f"{order=} must be <= data.order + 1 = {data.order + 1}"
        raise ValueError(msg)
    if not data.x_is_u:
        msg = "lnPi extrapolation requires x_is_u data"
        raise ValueError(msg)
    if derivatives is None:
        derivatives = factory_derivatives(name="lnPi", central=central, post_func=post_func)
    return ExtrapModel(
        alpha0=beta, data=data, derivatives=derivatives, order=order, minus_log=False, alpha_name=alpha_name
    )

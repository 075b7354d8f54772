r"""Taylor-series extrapolation model.

Counterpart of ``ExtrapModel`` in ``thermoextrap_tpu/models/extrap.py``
(the other models are not ported yet).  An array-valued ``alpha`` of shape
``(A,)`` gives outputs ``(A, *rest)``, ``rest`` being the coefficient batch
shape (replicates, values, ...).
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.series import derivs_from_coefs
from .derivatives import Derivatives

__all__ = ["ExtrapModel"]


def _alpha_powers(dalpha, order: int):
    """(A, order+1) or (order+1,) power stack."""
    out = [torch.ones_like(dalpha)]
    for _ in range(order):
        out.append(out[-1] * dalpha)
    return torch.stack(out, dim=-1)


def _poly_eval(coefs, dalpha, *, cumsum: bool = False, no_sum: bool = False):
    """Evaluate ``sum_m coefs[m] * dalpha^m``.

    ``coefs (order+1, *rest)``; ``dalpha`` a scalar or ``(A,)`` tensor.
    Returns ``(*A, *rest)``, or the terms with their order axis kept for
    ``cumsum`` / ``no_sum``.
    """
    order = coefs.shape[0] - 1
    dalpha = torch.as_tensor(dalpha, dtype=coefs.dtype, device=coefs.device)
    p = _alpha_powers(dalpha, order)
    terms = p.reshape(p.shape + (1,) * (coefs.ndim - 1)) * coefs
    if no_sum:
        return terms
    if cumsum:
        return torch.cumsum(terms, dim=dalpha.ndim)
    return terms.sum(dim=dalpha.ndim)


class ExtrapModel:
    """Taylor-series extrapolation in ``alpha`` about ``alpha0``."""

    def __init__(
        self,
        alpha0: float,
        data: Any,
        derivatives: Derivatives,
        order: int | None = None,
        minus_log: bool = False,
        alpha_name: str = "alpha",
    ) -> None:
        self.alpha0 = float(alpha0)
        self.data = data
        self.derivatives = derivatives
        self.order = int(data.order if order is None else order)
        self.minus_log = bool(minus_log)
        self.alpha_name = alpha_name
        self._coef_cache: dict = {}

    def __call__(self, *args, **kws):
        return self.predict(*args, **kws)

    def coefs(self, order=None, minus_log=None):
        order = self.order if order is None else int(order)
        minus_log = self.minus_log if minus_log is None else bool(minus_log)
        key = (order, minus_log)
        if key not in self._coef_cache:
            self._coef_cache[key] = self.derivatives.coefs(
                data=self.data, order=order, minus_log=minus_log
            )
        return self._coef_cache[key]

    def derivs(self, order=None, minus_log=None, norm=False):
        c = self.coefs(order=order, minus_log=minus_log)
        return c if norm else derivs_from_coefs(c)

    def predict(self, alpha, order=None, minus_log=None, cumsum: bool = False, no_sum: bool = False):
        coefs = self.coefs(order=order, minus_log=minus_log)
        alpha = torch.as_tensor(alpha, dtype=coefs.dtype, device=coefs.device)
        return _poly_eval(coefs, alpha - self.alpha0, cumsum=cumsum, no_sum=no_sum)

    def resample(self, sampler, **kws):
        return type(self)(
            alpha0=self.alpha0,
            data=self.data.resample(sampler, **kws),
            derivatives=self.derivatives,
            order=self.order,
            minus_log=self.minus_log,
            alpha_name=self.alpha_name,
        )

r"""Inverse-temperature (β) extrapolation factories.

Counterpart of ``thermoextrap_tpu/beta.py``: each named observable maps to a
closed-form series recursion of :mod:`.models.derivatives`.  Names:
``x_ave``, ``u_ave``, ``dun_ave``, ``dxdun_ave``, ``un_ave``, ``xun_ave``.
(``factory_perturbmodel`` waits for the perturbation kernels.)
"""

from __future__ import annotations

from functools import lru_cache

from .models.derivatives import (
    Derivatives,
    central_u_ave_coefs,
    central_x_ave_coefs,
    central_x_ave_coefs_xalpha,
    dun_ave_coefs,
    dxdun_ave_coefs,
    raw_u_ave_coefs,
    raw_x_ave_coefs,
    raw_x_ave_coefs_xalpha,
    un_ave_coefs,
    xun_ave_coefs,
)
from .models.extrap import ExtrapModel

__all__ = ["factory_derivatives", "factory_extrapmodel"]


def _build_coefs_fn(name: str, xalpha: bool, central: bool, n=None, d=None):
    """Map (name, flags) -> coefficient function of (derivs_args, order)."""
    if name == "x_ave":
        if central:
            if xalpha:
                return lambda args, order: central_x_ave_coefs_xalpha(*args, order)
            return lambda args, order: central_x_ave_coefs(*args, order)
        if xalpha:
            return lambda args, order: raw_x_ave_coefs_xalpha(*args, order)
        return lambda args, order: raw_x_ave_coefs(*args, order)

    if name == "u_ave":
        if central:
            return lambda args, order: central_u_ave_coefs(*args, order)
        return lambda args, order: raw_u_ave_coefs(*args, order)

    if name == "dun_ave":
        if central is False:
            msg = "dun_ave requires central moments"
            raise ValueError(msg)
        if n is None or int(n) <= 1:
            msg = f"{n=} must be > 1"
            raise ValueError(msg)
        return lambda args, order: dun_ave_coefs(args[-1], int(n), order)

    if name == "dxdun_ave":
        if central is False:
            msg = "dxdun_ave requires central moments"
            raise ValueError(msg)
        if n is None or int(n) <= 0:
            msg = f"{n=} must be positive"
            raise ValueError(msg)
        if xalpha:
            if not isinstance(d, int):
                msg = "xalpha dxdun_ave requires integer d"
                raise TypeError(msg)
            return lambda args, order: dxdun_ave_coefs(args[1], args[2], int(n), order, d=d)
        return lambda args, order: dxdun_ave_coefs(args[1], args[2], int(n), order)

    if name == "un_ave":
        if central:
            msg = "un_ave requires raw moments"
            raise ValueError(msg)
        if n is None or int(n) < 1:
            msg = f"{n=} must be >= 1"
            raise ValueError(msg)
        return lambda args, order: un_ave_coefs(args[0], int(n), order)

    if name == "xun_ave":
        if central:
            msg = "xun_ave requires raw moments"
            raise ValueError(msg)
        if n is None or int(n) < 0:
            msg = f"{n=} must be >= 0"
            raise ValueError(msg)
        if xalpha:
            if not isinstance(d, int) or d < 0:
                msg = "xalpha xun_ave requires integer d >= 0"
                raise ValueError(msg)
            return lambda args, order: xun_ave_coefs(args[0], args[1], int(n), order, d=d)
        return lambda args, order: xun_ave_coefs(args[0], args[1], int(n), order)

    msg = f"unknown observable name {name!r}"
    raise ValueError(msg)


@lru_cache(maxsize=64)
def factory_derivatives(
    name: str = "x_ave",
    n=None,
    d=None,
    xalpha: bool = False,
    central: bool | None = None,
    post_func=None,
) -> Derivatives:
    """Derivative engine for a named β observable."""
    central = False if central is None else bool(central)
    fn = _build_coefs_fn(name, bool(xalpha), central, n=n, d=d)
    return Derivatives(coefs_fn=fn, name=f"beta:{name}", post_func=post_func)


def factory_extrapmodel(
    beta: float,
    data,
    *,
    name: str = "x_ave",
    n=None,
    d=None,
    xalpha: bool | None = None,
    central: bool | None = None,
    order: int | None = None,
    alpha_name: str = "beta",
    derivatives: Derivatives | None = None,
    post_func=None,
    minus_log: bool = False,
) -> ExtrapModel:
    """ExtrapModel for the β expansion of a named observable of ``data``."""
    if xalpha is None:
        xalpha = data.xalpha
    if central is None:
        central = data.central
    if order is None:
        order = data.order

    if xalpha != data.xalpha:
        msg = f"{xalpha=} must equal {data.xalpha=}"
        raise ValueError(msg)
    if central != data.central:
        msg = f"{central=} must equal {data.central=}"
        raise ValueError(msg)
    if order > data.order:
        msg = f"{order=} must be <= {data.order=}"
        raise ValueError(msg)

    # n-indexed observables read moment entries up to n + order; x_is_u data
    # carries one extra entry for the u observables (u[n] = xu[n-1])
    shift = {"un_ave": 1, "dun_ave": 1, "xun_ave": 0, "dxdun_ave": 0}
    if derivatives is None and name in shift and n is not None:
        max_index = data.order + (shift[name] if data.x_is_u else 0)
        if int(n) + order > max_index:
            msg = (
                f"{name} with n={n} needs moment entries up to n + order = "
                f"{int(n) + order}, but the data provides indices only up to "
                f"{max_index} (data.order={data.order}); lower `order` or build "
                "the data with a larger order"
            )
            raise ValueError(msg)

    if derivatives is None:
        if name in {"u_ave", "un_ave", "dun_ave"} and not data.x_is_u:
            msg = "name in {u_ave, un_ave, dun_ave} requires data.x_is_u"
            raise ValueError(msg)
        derivatives = factory_derivatives(
            name=name, n=n, d=d, xalpha=xalpha, central=central, post_func=post_func
        )

    return ExtrapModel(
        alpha0=beta,
        data=data,
        derivatives=derivatives,
        order=order,
        minus_log=minus_log,
        alpha_name=alpha_name,
    )

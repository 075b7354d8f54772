"""Labeled-array (xarray-style) migration adapter.

Counterpart of ``thermoextrap_tpu/compat.py``.  The upstream thermoextrap
is xarray-native: every input carries named dims (``rec`` samples, ``val``
vector observable, ``deriv`` explicit-β derivative, ``rep`` replicates) and
constructors accept DataArrays in any axis order.  This package's compute
path is positional, which leaves a migration gap: an upstream user's arrays
arrive labeled, not laid out.

This module closes that gap without importing xarray (not a dependency):
anything with ``.dims`` (a tuple of names) and ``.values`` — a real
``xarray.DataArray``, or any duck-typed equivalent — is accepted, axes are
transposed into the package layout by NAME, and results can be re-wrapped
with labels via :class:`LabeledArray`.

Layout produced (the package convention, data.py:13-31):
``uv (*batch, rec)``, ``xv (*batch, rec, [deriv,] *val)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .data import factory_data_values
from .utils.device import host_numpy

__all__ = ["LabeledArray", "from_labeled", "predict_labeled"]


@dataclass(frozen=True)
class LabeledArray:
    """Minimal labeled array: ``values`` + ``dims``.  Quacks enough like an
    ``xarray.DataArray`` for round-tripping through :func:`from_labeled`;
    convert to the real thing with ``xr.DataArray(a.values, dims=a.dims)``.
    """

    values: np.ndarray
    dims: tuple[str, ...]

    def __post_init__(self):
        if np.ndim(self.values) != len(self.dims):
            msg = (
                f"values has {np.ndim(self.values)} axes but "
                f"{len(self.dims)} dims given: {self.dims}"
            )
            raise ValueError(msg)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)


def _split(a, what: str):
    dims = getattr(a, "dims", None)
    if dims is None:
        msg = (
            f"{what} must be a labeled array (xarray.DataArray or anything "
            f"with .dims and .values); got {type(a).__name__}"
        )
        raise TypeError(msg)
    return tuple(dims), np.asarray(getattr(a, "values", a))


def _transpose(dims, vals, want, what: str):
    if sorted(dims) != sorted(want):
        msg = f"{what} dims {dims} do not match expected dims {tuple(want)}"
        raise ValueError(msg)
    if tuple(dims) == tuple(want):
        return vals
    return np.transpose(vals, [dims.index(d) for d in want])


def from_labeled(
    uv,
    xv,
    order: int,
    *,
    rec_dim: str = "rec",
    deriv_dim: str | None = None,
    central: bool = False,
    x_is_u: bool = False,
    weight=None,
    meta=None,
):
    """Build a data object from labeled (xarray-style) timeseries.

    Accepts arrays in ANY axis order and transposes by dim NAME into the
    package layout, mirroring the reference's xarray constructors
    (upstream data.py:1686-1745 ``DataCentralMomentsVals.from_vals`` with
    ``rec_dim``/``deriv_dim`` kwargs).

    Parameters
    ----------
    uv : labeled array with ``rec_dim`` (extra dims become leading batch
        axes, in their ``uv`` order).
    xv : labeled array with ``rec_dim``, ``uv``'s batch dims, optionally
        ``deriv_dim``, and any number of value dims (kept trailing, in
        their ``xv`` order).
    order : max moment order.
    rec_dim, deriv_dim : dim names; a non-None ``deriv_dim`` implies an
        explicitly β-dependent observable (``xalpha=True``).
    central, x_is_u, weight, meta : as :func:`data.factory_data_values`
        (``weight`` may be labeled over ``rec_dim`` or a plain 1-D array).

    Examples
    --------
    >>> import numpy as np
    >>> uv = LabeledArray(np.array([1.0, 2.0, 3.0, 4.0]), ("rec",))
    >>> xv = LabeledArray(2.0 * np.ones((1, 4)), ("val", "rec"))  # any order
    >>> d = from_labeled(uv, xv, order=2, central=True)
    >>> float(d.uave), float(d.xave[0])
    (2.5, 2.0)
    """
    udims, uvals = _split(uv, "uv")
    if rec_dim not in udims:
        msg = f"uv has no {rec_dim!r} dim: {udims}"
        raise ValueError(msg)
    batch = tuple(d for d in udims if d != rec_dim)
    uvals = _transpose(udims, uvals, (*batch, rec_dim), "uv")

    xdims, xvals = _split(xv, "xv")
    xalpha = deriv_dim is not None
    if xalpha and deriv_dim not in xdims:
        msg = f"xv has no {deriv_dim!r} dim: {xdims}"
        raise ValueError(msg)
    val = tuple(
        d for d in xdims if d not in (rec_dim, deriv_dim) and d not in batch
    )
    want = (*batch, rec_dim, *((deriv_dim,) if xalpha else ()), *val)
    xvals = _transpose(xdims, xvals, want, "xv")

    if weight is not None and hasattr(weight, "dims"):
        wdims, wvals = _split(weight, "weight")
        weight = _transpose(wdims, wvals, (*batch, rec_dim), "weight")

    return factory_data_values(
        uv=uvals,
        xv=xvals,
        order=order,
        central=central,
        xalpha=xalpha,
        x_is_u=x_is_u,
        weight=weight,
        meta=meta,
    )


def predict_labeled(model, alphas, *, alpha_name: str | None = None, val_dims=None):
    """``model.predict`` with labeled output: dims ``(alpha, *val[, rep])``.

    ``alpha_name`` defaults to the model's own (``beta``, ``volume``, ...);
    ``val_dims`` defaults to ``("val_0", "val_1", ...)`` for however many
    value axes the prediction carries.
    """
    alphas = np.atleast_1d(np.asarray(alphas))
    out = host_numpy(model.predict(alphas))
    name = alpha_name or getattr(model, "alpha_name", "alpha")
    if val_dims is None:
        val_dims = tuple(f"val_{i}" for i in range(out.ndim - 1))
    else:
        val_dims = tuple(val_dims)
        if len(val_dims) != out.ndim - 1:
            msg = (
                f"prediction has {out.ndim - 1} value axes but "
                f"{len(val_dims)} val_dims given"
            )
            raise ValueError(msg)
    return LabeledArray(out, (name, *val_dims))

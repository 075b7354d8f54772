r"""Data layer: sample values and (co)moment containers on torch tensors.

Counterpart of ``thermoextrap_tpu/data.py``.  Layout conventions:

- ``uv``: ``(*batch, rec)`` energy-like samples; ``batch`` is empty or
  ``(rep,)`` after a bootstrap.
- ``xv``: ``(*batch, rec, [deriv+1,] *val)`` observable samples; the
  optional ``deriv`` axis holds the explicit β-derivatives ``x^{(d)}``.

``derivs_args`` gives the engine-ready tensors of
:mod:`.models.derivatives`: raw ``(u, xu)`` or central ``(xave, du, dxdu)``
(``(uave, du)`` when ``x_is_u``).  The containers are frozen dataclasses;
every tensor lives on the device of the samples it came from, and the
moment reductions run there (:mod:`.ops.dispatch`).  Their tensor fields are
the leaves of :mod:`.utils.trees` (``__tree_meta__`` names the static ones),
so that :mod:`.utils.checkpoint` saves any state built of them.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import os
from functools import cached_property
from math import comb
from typing import Any

import numpy as np
import torch

from .ops import dispatch
from .ops.convert import (
    central_comoments_from_raw,
    central_from_raw,
    merge_central_comoments,
    raw_from_central,
    u_from_xu_when_x_is_u,
)
from .ops.resample import freq_from_indices, random_indices, resample_values
from .utils.device import default_device, to_device
from .utils.random import validate_rng
from .utils.trace import span

__all__ = [
    "AbstractData",
    "DataCallback",
    "DataCallbackABC",
    "DataCentralMoments",
    "DataCentralMomentsBase",
    "DataCentralMomentsVals",
    "DataValues",
    "DataValuesBase",
    "DataValuesCentral",
    "factory_data_values",
]


_MOMENT_FIELDS = ("xave", "uave", "du", "dxdu", "wsum")


class DataCallbackABC:
    """Metadata hook: validate, extend ``derivs_args``, follow resampling."""

    def check(self, data) -> None:
        pass

    def derivs_args(self, data, derivs_args: tuple) -> tuple:
        return tuple(derivs_args)

    def resample(self, data, *, indices=None, freq=None, **kws):
        return self

    def reduce(self, data, **kws):
        return self


class DataCallback(DataCallbackABC):
    """Pass-through default callback; instances compare equal by type."""

    def __eq__(self, other) -> bool:
        return type(other) is type(self)

    def __hash__(self) -> int:
        return hash(type(self))


def _as_tensor(a, device=None):
    """numpy arrays, sequences and tensors → tensor (numpy keeps its type).
    With no ``device`` a tensor stays where it is and anything else goes to
    :func:`.utils.device.default_device` (onto a card through
    :func:`.utils.device.to_device`, which counts the copy's wait)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return to_device(np.asarray(a), default_device() if device is None else device)


def _host_f64(a):
    """An array or tensor as a float64 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _pad_val(a, val_ndim: int):
    """Append singleton axes so u-moments broadcast against x-moments."""
    return a.reshape(a.shape + (1,) * val_ndim) if val_ndim else a


def _normalize_sampler(sampler, nrec: int, device, rng=None):
    """Accept ``{"nrep": n}``, ``{"indices": ...}``, ``{"freq": ...}`` or a
    bare index array; returns ``(indices_or_None, freq)`` on ``device``."""
    if isinstance(sampler, dict):
        if "freq" in sampler:
            indices = sampler.get("indices")
            if indices is not None:
                indices = _as_tensor(indices, device)
            return indices, _as_tensor(sampler["freq"], device)
        if "indices" in sampler:
            indices = _as_tensor(sampler["indices"], device)
        else:
            gen = validate_rng(sampler.get("rng", rng), device=device)
            indices = random_indices(gen, sampler["nrep"], nrec, device=device)
        return indices, freq_from_indices(indices, nrec)
    indices = _as_tensor(sampler, device)
    if indices.ndim != 2:
        msg = "sampler array must be 2d bootstrap indices (nrep, nsamp)"
        raise ValueError(msg)
    return indices, freq_from_indices(indices, nrec)


# ---------------------------------------------------------------------------
# values-backed data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DataValues:
    """Raw timeseries container with lazy (co)moment accessors."""

    __tree_meta__ = ("meta", "order", "central", "x_is_u", "xalpha", "val_ndim")

    uv: torch.Tensor
    xv: torch.Tensor
    weight: torch.Tensor | None
    meta: Any
    order: int
    central: bool
    x_is_u: bool
    xalpha: bool
    val_ndim: int

    @classmethod
    def from_vals(
        cls,
        xv,
        uv,
        order: int,
        *,
        weight=None,
        central: bool = False,
        xalpha: bool = False,
        x_is_u: bool = False,
        val_ndim: int | None = None,
        meta: DataCallbackABC | None = None,
    ):
        uv = _as_tensor(uv)
        if xv is None:
            x_is_u = True
        xv = uv if x_is_u else _as_tensor(xv, uv.device)
        nb = uv.ndim - 1
        if val_ndim is None:
            val_ndim = xv.ndim - nb - 1 - (1 if xalpha else 0)
        if val_ndim < 0:
            msg = f"bad shapes: uv {tuple(uv.shape)}, xv {tuple(xv.shape)}, {xalpha=}"
            raise ValueError(msg)
        obj = cls(
            uv=uv,
            xv=xv,
            weight=None if weight is None else _as_tensor(weight, uv.device),
            meta=meta if meta is not None else DataCallback(),
            order=int(order),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=int(val_ndim),
        )
        obj.meta.check(obj)
        return obj

    def __len__(self) -> int:
        return self.uv.shape[-1]

    @property
    def nbatch(self) -> int:
        return self.uv.ndim - 1

    @property
    def _xval_ndim(self) -> int:
        """val axes of xv including the deriv axis."""
        return self.val_ndim + (1 if self.xalpha else 0)

    @cached_property
    def _raw(self):
        return dispatch.reduce_raw(
            self.uv, self.xv, self.order, weight=self.weight, val_ndim=self._xval_ndim
        )

    @cached_property
    def _central(self):
        return dispatch.reduce_central(
            self.uv,
            self.xv,
            self.order,
            weight=self.weight,
            val_ndim=self._xval_ndim,
            x_is_u=self.x_is_u,
        )

    def _move_deriv(self, a, has_mom_axis: bool = True):
        """Move the deriv axis (stored after batch) to just behind the moment axis."""
        if not self.xalpha:
            return a
        src = (1 if has_mom_axis else 0) + self.nbatch
        return torch.movedim(a, src, 1 if has_mom_axis else 0)

    @cached_property
    def xu(self):
        """Raw comoments ``<x^{(d)} u^n>``: ``(order+1, [deriv+1,] *batch, *val)``."""
        return self._move_deriv(self._raw[1])

    @cached_property
    def u(self):
        """Raw u-moments, broadcast-padded: ``(order+1|+2, *batch, 1...)``."""
        if self.x_is_u:
            return u_from_xu_when_x_is_u(self._raw[1])
        return _pad_val(self._raw[0], self.val_ndim)

    @cached_property
    def xave(self):
        """``<x^{(d)}>``: ``([deriv+1,] *batch, *val)``."""
        return self._move_deriv(self._central[0], has_mom_axis=False)

    @cached_property
    def uave(self):
        return self._central[1]

    @cached_property
    def dxdu(self):
        """Central comoments ``<dx^{(d)} du^n>``: ``(order+1, [deriv+1,] *batch, *val)``."""
        return self._move_deriv(self._central[3])

    @cached_property
    def du(self):
        """Central u-moments, padded: ``du[0]=1, du[1]=0``."""
        if self.x_is_u:
            return u_from_xu_when_x_is_u(self._central[3], fill0=1.0)
        return _pad_val(self._central[2], self.val_ndim)

    @property
    def derivs_args(self) -> tuple:
        if self.central:
            out = (self.uave, self.du) if self.x_is_u else (self.xave, self.du, self.dxdu)
        elif self.x_is_u:
            out = (self.u,)
        else:
            out = (self.u, self.xu)
        return self.meta.derivs_args(self, out)

    def resample(self, sampler, *, rng=None, **kws):
        """Bootstrap: a new object whose values have a leading rep axis."""
        if self.nbatch:
            msg = "resample of already-replicated data is not supported"
            raise NotImplementedError(msg)
        indices, freq = _normalize_sampler(sampler, len(self), self.uv.device, rng=rng)
        if indices is None:
            msg = "DataValues.resample needs index-style sampler"
            raise ValueError(msg)
        uv = resample_values(self.uv, indices, rec_axis=0)
        xv = uv if self.x_is_u else resample_values(self.xv, indices, rec_axis=0)
        weight = (
            None
            if self.weight is None
            else resample_values(torch.broadcast_to(self.weight, self.uv.shape), indices, rec_axis=0)
        )
        meta = self.meta.resample(self, indices=indices, freq=freq, **kws)
        return dataclasses.replace(self, uv=uv, xv=xv, weight=weight, meta=meta)


class DataValuesCentral(DataValues):
    """Values-backed data using central moments."""

    @classmethod
    def from_vals(cls, xv, uv, order, **kws):
        kws.setdefault("central", True)
        return super().from_vals(xv, uv, order, **kws)


# ---------------------------------------------------------------------------
# moment-backed data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DataCentralMoments:
    """Pre-reduced central comoment container.

    Shapes: ``xave ([deriv+1,] *batch, *val)``, ``du (order+1, *batch,
    1...)``, ``dxdu (order+1, [deriv+1,] *batch, *val)``, ``uave (*batch,)``,
    ``wsum (*batch,)``.
    """

    __tree_meta__ = ("meta", "order", "central", "x_is_u", "xalpha", "val_ndim")

    xave: torch.Tensor
    uave: torch.Tensor
    du: torch.Tensor
    dxdu: torch.Tensor
    wsum: torch.Tensor
    meta: Any
    order: int
    central: bool
    x_is_u: bool
    xalpha: bool
    val_ndim: int

    @classmethod
    def from_vals(
        cls,
        xv,
        uv,
        order: int,
        *,
        weight=None,
        central: bool = True,
        xalpha: bool = False,
        x_is_u: bool = False,
        meta: DataCallbackABC | None = None,
    ):
        if xv is None:
            x_is_u = True
        dv = DataValues.from_vals(
            xv, uv, order, weight=weight, central=True, xalpha=xalpha, x_is_u=x_is_u, meta=meta
        )
        xave, uave, du, dxdu = dv._central
        # weights never drop below float32: a bf16 stream must not quantize
        # the sample count
        wdtype = torch.promote_types(dv.uv.dtype, torch.float32)
        if dv.weight is None:
            wsum = torch.full(dv.uv.shape[:-1], dv.uv.shape[-1], dtype=wdtype, device=dv.uv.device)
        else:
            wsum = torch.broadcast_to(dv.weight.to(wdtype), dv.uv.shape).sum(-1)
        return cls(
            xave=dv._move_deriv(xave, has_mom_axis=False),
            uave=uave,
            du=_pad_val(du, dv.val_ndim),
            dxdu=dv._move_deriv(dxdu),
            wsum=wsum,
            meta=dv.meta,
            order=int(order),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=dv.val_ndim,
        )

    @classmethod
    def from_ave_central(
        cls,
        xave,
        uave,
        du,
        dxdu,
        *,
        wsum=None,
        central: bool = True,
        xalpha: bool = False,
        x_is_u: bool = False,
        val_ndim: int | None = None,
        meta: DataCallbackABC | None = None,
    ):
        dxdu = _as_tensor(dxdu)
        device = dxdu.device
        du = _as_tensor(du, device)
        xave = _as_tensor(xave, device)
        uave = _as_tensor(uave, device)
        order = dxdu.shape[0] - 1
        if val_ndim is None:
            val_ndim = dxdu.ndim - 1 - (1 if xalpha else 0) - uave.ndim
        # du in the canonical pad convention: (order+1, *batch) + val pads
        du = du.reshape((order + 1, *uave.shape) + (1,) * int(val_ndim))
        if du.shape[0] > 1:
            du = torch.cat([torch.ones_like(du[:1]), torch.zeros_like(du[1:2]), du[2:]])
        return cls(
            xave=xave,
            uave=uave,
            du=du,
            dxdu=torch.cat([torch.zeros_like(dxdu[:1]), dxdu[1:]]),
            wsum=torch.ones_like(uave) if wsum is None else _as_tensor(wsum, device),
            meta=meta if meta is not None else DataCallback(),
            order=int(order),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=int(val_ndim),
        )

    @classmethod
    def from_raw(
        cls,
        u,
        xu=None,
        *,
        wsum=None,
        central: bool = False,
        xalpha: bool = False,
        x_is_u: bool = False,
        val_ndim: int | None = None,
        meta: DataCallbackABC | None = None,
    ):
        """From raw moments ``u[n] = <u^n>`` (``n = 0..K``, moment axis
        leading, ``u[0] = 1``) and ``xu[n] = <x u^n>``.

        With ``x_is_u=True`` (or ``xu=None``), ``xu[n] = u[n+1]`` by the shift
        trick and ``order = K - 1``.  The raw → central conversion runs in
        float64 on the host whatever the inputs' type (large raw energy
        moments cancel catastrophically in float32); the fields land on the
        device of ``u`` when it is a tensor, else on the CPU.
        """
        device = u.device if isinstance(u, torch.Tensor) else None
        u = _host_f64(u)

        def dev(a):
            return a if device is None else a.to(device)

        wsum_t = None if wsum is None else _as_tensor(wsum, device)
        if x_is_u or xu is None:
            du_full = dev(central_from_raw(u))  # K+1 entries
            uave = dev(u[1])
            order = int(u.shape[0] - 2)
            return cls(
                xave=uave,
                uave=uave,
                du=du_full[: order + 1],
                dxdu=du_full[1:],  # <du du^n> = du[n+1], n = 0..order
                wsum=torch.ones_like(uave) if wsum_t is None else wsum_t,
                meta=meta if meta is not None else DataCallback(),
                order=order,
                central=bool(central),
                x_is_u=True,
                xalpha=False,
                val_ndim=0 if val_ndim is None else int(val_ndim),
            )
        xu = _host_f64(xu)
        if val_ndim is None:
            val_ndim = xu.ndim - u.ndim - (1 if xalpha else 0)
        u_b = _pad_val(u, xu.ndim - u.ndim)
        xave, du, dxdu = (dev(a) for a in central_comoments_from_raw(u_b, xu))
        uave = dev(u[1])
        return cls(
            xave=xave,
            uave=uave,
            du=du,
            dxdu=dxdu,
            wsum=torch.ones_like(uave) if wsum_t is None else wsum_t,
            meta=meta if meta is not None else DataCallback(),
            order=int(u.shape[0] - 1),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=int(val_ndim),
        )

    # the reference's alias: the same contract, moment axis leading
    from_ave_raw = from_raw

    @classmethod
    def from_data(
        cls,
        data,
        *,
        central: bool = False,
        x_is_u: bool = False,
        xalpha: bool = False,
        val_ndim: int = 0,
        meta: DataCallbackABC | None = None,
    ):
        """From a central (co)moment tensor in the cmomy layout, moment axes
        trailing (the inverse of :meth:`cmom`), as float64 on the device of
        ``data`` (the default device for an array):

        - ``x_is_u=False``: ``data (*batch, *val, 2, order+1)`` with
          ``data[..., 0, 0] = weight``, ``data[..., 1, 0] = <x>``,
          ``data[..., 0, 1] = <u>``, ``data[..., 0, j>=2] = <du^j>``,
          ``data[..., 1, j>=1] = <dx du^j>``.
        - ``x_is_u=True``: ``data (*batch, K+1)``, the u-moments ``[w, <u>,
          <du^2>, ...]``, read as comoments of x = u with ``order = K - 1``.

        ``val_ndim`` counts the trailing value axes of the batch part; the
        u-moment slices are read at value index 0.

        Examples
        --------
        >>> import numpy as np
        >>> d = DataCentralMoments.from_data(
        ...     np.array([10.0, 2.0, 0.5, 0.1]), x_is_u=True, central=True
        ... )  # [w, <u>, <du^2>, <du^3>] -> order 2
        >>> d.order
        2
        >>> float(d.uave), [float(v) for v in d.du]
        (2.0, [1.0, 0.0, 0.5])
        """
        data = _as_tensor(data).to(torch.float64)
        if xalpha:
            msg = "from_data with a deriv axis is not supported; use from_ave_central"
            raise NotImplementedError(msg)
        meta = meta if meta is not None else DataCallback()
        if x_is_u:
            order = int(data.shape[-1] - 2)
            if order < 0:
                msg = f"x_is_u data needs >= 2 moment entries, got {tuple(data.shape)}"
                raise ValueError(msg)
            du_full = torch.movedim(data, -1, 0).clone()  # (K+1, *batch)
            wsum, uave = du_full[0].clone(), du_full[1].clone()
            du_full[0] = 1.0
            du_full[1] = 0.0
            return cls(
                xave=uave,
                uave=uave,
                du=du_full[: order + 1],
                dxdu=du_full[1:],  # <du du^n> = du[n+1]
                wsum=wsum,
                meta=meta,
                order=order,
                central=bool(central),
                x_is_u=True,
                xalpha=False,
                val_ndim=0,
            )
        if data.ndim < 2 or data.shape[-2] != 2:
            msg = f"expected trailing (xmom=2, umom) axes, got {tuple(data.shape)}"
            raise ValueError(msg)
        order = int(data.shape[-1] - 1)
        idx0 = (Ellipsis, *(0,) * val_ndim)
        du = torch.movedim(data[..., 0, :], -1, 0)[(slice(None), *idx0)].clone()  # (order+1, *batch)
        du[0] = 1.0
        if order >= 1:
            du[1] = 0.0
        dxdu = torch.movedim(data[..., 1, :], -1, 0).clone()
        dxdu[0] = 0.0
        return cls(
            xave=data[..., 1, 0].clone(),
            uave=data[..., 0, 1][idx0].clone(),
            du=_pad_val(du, val_ndim),
            dxdu=dxdu,
            wsum=data[..., 0, 0][idx0].clone(),
            meta=meta,
            order=order,
            central=bool(central),
            x_is_u=False,
            xalpha=False,
            val_ndim=int(val_ndim),
        )

    @classmethod
    def from_resample_vals(
        cls,
        xv,
        uv,
        order: int,
        sampler,
        *,
        weight=None,
        central: bool = True,
        x_is_u: bool = False,
        xalpha: bool = False,
        rng=None,
        meta: DataCallbackABC | None = None,
    ):
        """Bootstrap straight into a replicated moment container: the count
        table drives the bootstrap reduction (K2 on the card); an ``xalpha``
        deriv axis rides as extra value columns."""
        if xalpha and (x_is_u or xv is None):
            msg = (
                "from_resample_vals: xalpha needs an explicit "
                "xv (rec, deriv+1, *val); it is meaningless with x_is_u"
            )
            raise ValueError(msg)
        uv = _as_tensor(uv)
        xv = uv if (x_is_u or xv is None) else _as_tensor(xv, uv.device)
        weight = None if weight is None else _as_tensor(weight, uv.device)
        indices, freq = _normalize_sampler(sampler, uv.shape[-1], uv.device, rng=rng)
        val_shape = tuple(xv.shape[1:])
        xflat = xv.reshape(uv.shape[-1], -1)
        xave, uave, du, dxdu = dispatch.resample_central(uv, xflat, freq, order, weight=weight)
        nrep = freq.shape[0]
        xave = xave.reshape((nrep, *val_shape))
        dxdu = dxdu.reshape((order + 1, nrep, *val_shape))
        if xalpha:
            xave = torch.movedim(xave, 1, 0)
            dxdu = torch.movedim(dxdu, 2, 1)
            val_shape = val_shape[1:]
        # the reference's promotion: the counts take the stream type, the
        # weights keep their own, and the product runs in the promoted type
        # (bfloat16 streams with a float32 weight give float32 sums)
        f = freq.to(uv.dtype)
        w = torch.ones_like(uv) if weight is None else torch.broadcast_to(weight, uv.shape)
        dtype = torch.promote_types(f.dtype, w.dtype)
        wsum = f.to(dtype) @ w.to(dtype)
        obj = cls(
            xave=xave,
            uave=uave,
            du=_pad_val(du, len(val_shape)),
            dxdu=dxdu,
            wsum=wsum,
            meta=meta if meta is not None else DataCallback(),
            order=int(order),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=len(val_shape),
        )
        if meta is not None:
            obj = dataclasses.replace(obj, meta=meta.resample(obj, indices=indices, freq=freq))
        return obj

    # -- streaming accumulation ---------------------------------------------
    # Each chunk is reduced on its own (K1 / K4 on the card) and pooled with
    # the running state by the exact shifted-moment merge, as if all samples
    # had been reduced in one shot; no samples are kept.

    @classmethod
    def zeros(
        cls,
        order: int,
        *,
        val_shape: tuple[int, ...] = (),
        batch_shape: tuple[int, ...] = (),
        deriv: int | None = None,
        dtype=torch.float64,
        device=None,
        central: bool = True,
        x_is_u: bool = False,
        xalpha: bool = False,
        meta: DataCallbackABC | None = None,
    ):
        """Empty (zero-weight) accumulator state on ``device`` (the default
        device when None).

        ``batch_shape`` adds kept batch axes (a macrostate grid, replicates)
        that chunks pool into elementwise.  ``deriv`` (xalpha only, flat) is
        the size of the explicit β-derivative axis (``order + 1`` by
        default).  Merging the empty state with a chunk returns that chunk's
        moments; ``derivs_args`` of a still-empty state is undefined (0/0).
        """
        val_shape = tuple(val_shape)
        batch_shape = tuple(batch_shape)
        if xalpha and batch_shape:
            msg = "zeros with both a deriv axis and batch axes is not supported"
            raise ValueError(msg)
        device = default_device() if device is None else torch.device(device)
        d = (int(deriv) if deriv is not None else order + 1,) if xalpha else ()

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        du = z(order + 1, *batch_shape, *(1,) * len(val_shape))
        du[0] = 1.0
        return cls(
            xave=z(*d, *batch_shape, *val_shape),
            uave=z(*batch_shape),
            du=du,
            dxdu=z(order + 1, *d, *batch_shape, *val_shape),
            wsum=z(*batch_shape),
            meta=meta if meta is not None else DataCallback(),
            order=int(order),
            central=bool(central),
            x_is_u=bool(x_is_u),
            xalpha=bool(xalpha),
            val_ndim=len(val_shape),
        )

    def merge(self, *others: "DataCentralMoments"):
        """Exactly pool this moment state with ``others`` (each weighted by
        its ``wsum``), as if all their samples had been reduced in one shot.
        Batch axes are kept and pooled elementwise; ``xalpha`` is supported
        for flat states.  The result keeps this state's dtype and device.
        The pooling is a ``te.merge`` span."""
        states = (self, *others)
        for o in others:
            same = (
                o.order == self.order
                and o.central == self.central
                and o.x_is_u == self.x_is_u
                and o.xalpha == self.xalpha
                and o.val_ndim == self.val_ndim
                and o.wsum.shape == self.wsum.shape
            )
            if not same:
                msg = "merge requires identical order/central/x_is_u/xalpha/val_ndim and batch shape"
                raise ValueError(msg)
        if self.xalpha and self.wsum.ndim != 0:
            msg = "merge with both a deriv axis and batch axes is not supported"
            raise ValueError(msg)

        def stack(name, dim):
            like = getattr(self, name)
            return torch.stack([getattr(s, name).to(like) for s in states], dim=dim)

        with span("te.merge"):
            # the states' axis leads the means and weights and follows the
            # moment axis; an xalpha deriv axis stays behind it as one more
            # value axis
            dxdu = stack("dxdu", 1)
            du = torch.stack([_pad_val(s.du, s.dxdu.ndim - s.du.ndim).to(self.du) for s in states], dim=1)
            xave, uave, du, dxdu, wsum = merge_central_comoments(
                stack("xave", 0), stack("uave", 0), du, dxdu, stack("wsum", 0), axis=0
            )
            du = du.reshape((self.order + 1, *uave.shape) + (1,) * self.val_ndim)
            return dataclasses.replace(
                self, xave=xave, uave=uave, du=du, dxdu=dxdu, wsum=wsum, meta=self.meta.reduce(self)
            )

    def push_vals(self, xv, uv, *, weight=None):
        """Streaming update: reduce one chunk of samples (``xv`` is ignored
        with ``x_is_u``) and merge it into this state; returns the new
        state.  Arrays that are not tensors go to this state's device."""
        if not isinstance(uv, torch.Tensor):
            uv = _as_tensor(uv, self.wsum.device)  # xv and weight follow uv
        chunk = type(self).from_vals(
            None if self.x_is_u else xv,
            uv,
            self.order,
            weight=weight,
            central=self.central,
            xalpha=self.xalpha,
            x_is_u=self.x_is_u,
            meta=self.meta,
        )
        return self.merge(chunk)

    def save(self, path) -> None:
        """Checkpoint the moment state to one ``.npz`` file (``.npz`` is
        appended to a path without it), in the JAX package's layout: the five
        fields as arrays and a JSON ``_header`` with the flags and each
        field's dtype name.  bfloat16 is stored as float32 (exact) and
        restored to bfloat16.  ``meta`` is not stored: pass it to
        :meth:`load`."""
        arrays, dtypes = {}, {}
        for k in _MOMENT_FIELDS:
            a = getattr(self, k).detach()
            dtypes[k] = str(a.dtype).removeprefix("torch.")
            arrays[k] = (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
        header = {
            "order": self.order,
            "central": self.central,
            "x_is_u": self.x_is_u,
            "xalpha": self.xalpha,
            "val_ndim": self.val_ndim,
            "dtypes": dtypes,
        }
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, _header=json.dumps(header), **arrays)

    @classmethod
    def load(cls, path, *, meta: DataCallbackABC | None = None):
        """Restore a state written by :meth:`save` (by either package), on
        the default device."""
        path = str(path)
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        device = default_device()
        with np.load(path) as z:
            header = json.loads(str(z["_header"]))
            fields = {
                k: torch.as_tensor(z[k], device=device).to(getattr(torch, header["dtypes"][k]))
                for k in _MOMENT_FIELDS
            }
        return cls(
            **fields,
            meta=meta if meta is not None else DataCallback(),
            order=int(header["order"]),
            central=bool(header["central"]),
            x_is_u=bool(header["x_is_u"]),
            xalpha=bool(header["xalpha"]),
            val_ndim=int(header["val_ndim"]),
        )

    def __len__(self) -> int:
        return int(self.wsum if self.wsum.ndim == 0 else self.wsum.reshape(-1)[0])

    @property
    def _du_norm(self):
        """``du`` in the canonical pad convention ``(order+1, *batch)`` + val pads."""
        return self.du.reshape((self.order + 1, *self.wsum.shape) + (1,) * self.val_ndim)

    @cached_property
    def u(self):
        """Raw u-moments from the central representation (padded)."""
        if self.x_is_u:
            return u_from_xu_when_x_is_u(self.xu)
        du = self._du_norm
        return raw_from_central(du, _pad_val(self.uave, du.ndim - 1 - self.uave.ndim))

    @cached_property
    def xu(self):
        """Raw comoments ``<x u^n> = xave <u^n> + sum_k C(n,k) uave^{n-k} <dx du^k>``."""
        du_b = self._du_norm
        uave_b = _pad_val(self.uave, du_b.ndim - 1 - self.uave.ndim)
        u_b = raw_from_central(du_b, uave_b)
        if self.xalpha:
            u_b = u_b[:, None]
            uave_p = uave_b[None]
        else:
            uave_p = uave_b
        pw = [torch.ones_like(uave_p)]
        for _ in range(self.order):
            pw.append(pw[-1] * uave_p)
        rows = []
        for n in range(self.order + 1):
            s = self.xave * u_b[n]
            for k in range(1, n + 1):
                s = s + comb(n, k) * pw[n - k] * self.dxdu[k]
            rows.append(s)
        return torch.stack(torch.broadcast_tensors(*rows), dim=0)

    @property
    def du_x(self):
        """du with the x_is_u shift applied when needed."""
        if self.x_is_u:
            return u_from_xu_when_x_is_u(self.dxdu, fill0=1.0)
        return self.du

    def _dtype(self):
        return torch.promote_types(self.dxdu.dtype, self.wsum.dtype)

    def cmom(self):
        """The central comoment tensor in the cmomy layout, moment axes
        trailing; the inverse of :meth:`from_data`.  ``x_is_u``: ``(*batch,
        order+2)`` ``[w, <u>, <du^2>, ...]``; else ``(*batch, *val, 2,
        order+1)`` with ``[..., 0, 0] = w``, ``[..., 0, 1] = <u>``, ``[..., 0,
        j>=2] = <du^j>``, ``[..., 1, 0] = <x>``, ``[..., 1, j>=1] = <dx
        du^j>``."""
        if self.xalpha:
            msg = "cmom with a deriv axis is not supported"
            raise NotImplementedError(msg)
        dt = self._dtype()
        if self.x_is_u:
            full = self.du_x.to(dt).clone()
            full[0] = self.wsum
            full[1] = self.uave
            return torch.movedim(full, 0, -1)
        b_val = self.dxdu.shape[1:]
        wsum_b = torch.broadcast_to(_pad_val(self.wsum, self.val_ndim), b_val)
        uave_b = torch.broadcast_to(_pad_val(self.uave, self.val_ndim), b_val)
        du_b = torch.broadcast_to(self._du_norm, (self.order + 1, *b_val))
        rows0 = [wsum_b] + ([uave_b] if self.order >= 1 else []) + list(du_b[2:])
        rows1 = [self.xave] + list(self.dxdu[1:])
        out = torch.stack([torch.stack([r.to(dt) for r in rows0]), torch.stack([r.to(dt) for r in rows1])])
        return torch.movedim(out, (0, 1), (-2, -1))

    def rmom(self):
        """The raw comoment tensor in the cmomy layout, moment axes trailing:
        the shapes of :meth:`cmom`, with ``[..., 0, j>=1] = <u^j>`` and
        ``[..., 1, j] = <x u^j>`` (the weight still at ``[..., 0, 0]``)."""
        if self.xalpha:
            msg = "rmom with a deriv axis is not supported"
            raise NotImplementedError(msg)
        dt = self._dtype()
        if self.x_is_u:
            full = self.u.to(dt).clone()
            full[0] = self.wsum
            return torch.movedim(full, 0, -1)
        xu = self.xu.to(dt)
        b_val = xu.shape[1:]
        wsum_b = torch.broadcast_to(_pad_val(self.wsum, self.val_ndim), b_val).to(dt)
        row0 = torch.broadcast_to(self.u, (self.order + 1, *b_val)).to(dt)
        out = torch.stack([torch.cat([wsum_b[None], row0[1:]]), xu])
        return torch.movedim(out, (0, 1), (-2, -1))

    @property
    def derivs_args(self) -> tuple:
        if self.central:
            out = (self.uave, self.du_x) if self.x_is_u else (self.xave, self.du, self.dxdu)
        elif self.x_is_u:
            out = (self.u,)
        else:
            out = (self.u, self.xu)
        return self.meta.derivs_args(self, out)

    def _merge_along(self, wsum, axis: int, fields=None):
        """The exact shifted-moment merge of ``fields`` (``(xave, uave, du,
        dxdu)``, this state's by default); an xalpha deriv axis rides as a
        trailing value axis."""
        xave, uave, du, dxdu = (self.xave, self.uave, self.du, self.dxdu) if fields is None else fields
        if not self.xalpha:
            return merge_central_comoments(xave, uave, du, dxdu, wsum, axis=axis)
        x2 = torch.movedim(xave, 0, -1)
        dxdu2 = torch.movedim(dxdu, 1, -1)
        x_p, u_p, du_m, dxdu_m, w = merge_central_comoments(x2, uave, du, dxdu2, wsum, axis=axis)
        return torch.movedim(x_p, -1, 0), u_p, du_m[..., 0], torch.movedim(dxdu_m, -1, 1), w

    def reduce(self, axis: int = 0):
        """Merge the moment sets along ONE batch axis into a pooled set."""
        xave, uave, du, dxdu, wsum = self._merge_along(self.wsum, axis)
        return dataclasses.replace(
            self, xave=xave, uave=uave, du=du, dxdu=dxdu, wsum=wsum, meta=self.meta.reduce(self)
        )

    def resample(self, sampler, *, axis: int = 0, rng=None, **kws):
        """Block bootstrap over pre-reduced moment blocks along one batch
        axis: replicate ``r`` reweights block ``b`` by ``freq[r, b]`` and
        pools all blocks with the exact merge.  The replicate axis leads the
        remaining batch axes."""
        nb = self.wsum.ndim
        if nb == 0:
            msg = (
                "moment-backed resample needs a block batch axis; this state "
                "is a single pooled moment set (build per-block states, e.g. "
                "from_vals on (nblock, rec) values, then resample)"
            )
            raise ValueError(msg)
        axis = int(axis) % nb
        nblock = self.wsum.shape[axis]
        indices, freq = _normalize_sampler(sampler, nblock, self.wsum.device, rng=rng)
        freq = freq.to(self.wsum.dtype)
        nrep = freq.shape[0]
        bshape = [nrep] + [1] * nb
        bshape[axis + 1] = nblock
        # one merge over a leading replicate axis (the reference vmaps one
        # merge): every state field gets the replicate axis where its batch
        # axes begin, the replicate weights lead wsum, and the merge runs
        # along the block axis, now axis + 1
        xa = self.xalpha
        rep_axes = (1 if xa else 0, 0, 1, 2 if xa else 1)
        fields = tuple(
            t.unsqueeze(ax).expand(*t.shape[:ax], nrep, *t.shape[ax:])
            for t, ax in zip((self.xave, self.uave, self.du, self.dxdu), rep_axes)
        )
        xave, uave, du, dxdu, wsum = self._merge_along(self.wsum * freq.reshape(bshape), axis + 1, fields)
        meta = self.meta.resample(self, indices=indices, freq=freq, **kws)
        return dataclasses.replace(self, xave=xave, uave=uave, du=du, dxdu=dxdu, wsum=wsum, meta=meta)


class DataCentralMomentsVals(DataValues):
    """Values-backed central-moment data whose ``resample`` reduces through
    the count-table bootstrap (K2 on the card) instead of materializing
    resampled values."""

    @classmethod
    def from_vals(cls, xv, uv, order, **kws):
        kws.setdefault("central", True)
        return super().from_vals(xv, uv, order, **kws)

    def resample(self, sampler, *, rng=None, **kws):
        if self.nbatch:
            return super().resample(sampler, rng=rng, **kws)
        indices, freq = _normalize_sampler(sampler, len(self), self.uv.device, rng=rng)
        return DataCentralMoments.from_resample_vals(
            None if self.x_is_u else self.xv,
            self.uv,
            self.order,
            {"indices": indices, "freq": freq},
            weight=self.weight,
            central=self.central,
            x_is_u=self.x_is_u,
            xalpha=self.xalpha,
            meta=self.meta,
        )


def factory_data_values(
    uv,
    xv,
    order: int,
    *,
    central: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    weight=None,
    meta=None,
    **_kws,
):
    """DataValues or DataValuesCentral, by ``central``.

    Examples
    --------
    >>> import numpy as np
    >>> uv = np.array([1.0, 2.0, 3.0, 4.0])
    >>> xv = np.array([2.0, 4.0, 6.0, 8.0])
    >>> d = factory_data_values(uv=uv, xv=xv, order=2, central=True)
    >>> float(d.uave), float(d.xave)
    (2.5, 5.0)
    >>> [float(v) for v in d.du]  # du[0]=1, du[1]=0, du[2]=Var[u]
    [1.0, 0.0, 1.25]
    """
    cls = DataValuesCentral if central else DataValues
    return cls.from_vals(
        xv, uv, order, weight=weight, central=central, xalpha=xalpha, x_is_u=x_is_u, meta=meta
    )


# Virtual bases of the JAX package's data module: reference-style
# ``isinstance(data, AbstractData)`` checks hold on the port's two concrete
# classes without making them share an implementation.


class AbstractData(abc.ABC):
    """Virtual common base of every data class."""


class DataValuesBase(abc.ABC):
    """Virtual base of the value-backed classes."""


class DataCentralMomentsBase(abc.ABC):
    """Virtual base of the moment-backed classes."""


AbstractData.register(DataValues)
AbstractData.register(DataCentralMoments)
DataValuesBase.register(DataValues)
DataCentralMomentsBase.register(DataCentralMoments)
DataCentralMomentsBase.register(DataCentralMomentsVals)

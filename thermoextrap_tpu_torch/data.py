r"""Data layer: sample values and (co)moment containers on torch tensors.

Counterpart of ``thermoextrap_tpu/data.py`` (its streaming methods ``zeros``
/ ``merge`` / ``push_vals`` are not ported yet).  Layout conventions:

- ``uv``: ``(*batch, rec)`` energy-like samples; ``batch`` is empty or
  ``(rep,)`` after a bootstrap.
- ``xv``: ``(*batch, rec, [deriv+1,] *val)`` observable samples; the
  optional ``deriv`` axis holds the explicit β-derivatives ``x^{(d)}``.

``derivs_args`` gives the engine-ready tensors of
:mod:`.models.derivatives`: raw ``(u, xu)`` or central ``(xave, du, dxdu)``
(``(uave, du)`` when ``x_is_u``).  The containers are frozen dataclasses;
every tensor lives on the device of the samples it came from, and the
moment reductions run there (:mod:`.ops.dispatch`).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from math import comb
from typing import Any

import numpy as np
import torch

from .ops import dispatch
from .ops.convert import merge_central_comoments, raw_from_central, u_from_xu_when_x_is_u
from .ops.resample import freq_from_indices, random_indices, resample_values
from .utils.random import validate_rng

__all__ = [
    "DataCallback",
    "DataCallbackABC",
    "DataCentralMoments",
    "DataCentralMomentsVals",
    "DataValues",
    "DataValuesCentral",
    "factory_data_values",
]


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
    """numpy arrays, sequences and tensors → tensor (numpy keeps its type)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


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
            gen = validate_rng(sampler.get("rng", rng))
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
        w = torch.ones_like(uv) if weight is None else torch.broadcast_to(weight.to(uv.dtype), uv.shape)
        wsum = freq.to(uv.dtype) @ w
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

    @property
    def derivs_args(self) -> tuple:
        if self.central:
            out = (self.uave, self.du_x) if self.x_is_u else (self.xave, self.du, self.dxdu)
        elif self.x_is_u:
            out = (self.u,)
        else:
            out = (self.u, self.xu)
        return self.meta.derivs_args(self, out)

    def _merge_along(self, wsum, axis: int):
        """The exact shifted-moment merge; an xalpha deriv axis rides as a
        trailing value axis."""
        if not self.xalpha:
            return merge_central_comoments(self.xave, self.uave, self.du, self.dxdu, wsum, axis=axis)
        x2 = torch.movedim(self.xave, 0, -1)
        dxdu2 = torch.movedim(self.dxdu, 1, -1)
        x_p, u_p, du_m, dxdu_m, w = merge_central_comoments(x2, self.uave, self.du, dxdu2, wsum, axis=axis)
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
        bshape = [1] * nb
        bshape[axis] = nblock
        reps = [self._merge_along(self.wsum * f.reshape(bshape), axis) for f in freq]
        xa = self.xalpha
        out_axes = (1 if xa else 0, 0, 1, 2 if xa else 1, 0)
        xave, uave, du, dxdu, wsum = (
            torch.stack([rep[i] for rep in reps], dim=ax) for i, ax in enumerate(out_axes)
        )
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
    """DataValues or DataValuesCentral, by ``central``."""
    cls = DataValuesCentral if central else DataValues
    return cls.from_vals(
        xv, uv, order, weight=weight, central=central, xalpha=xalpha, x_is_u=x_is_u, meta=meta
    )

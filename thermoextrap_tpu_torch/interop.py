"""States carried between the JAX package and the torch port.

The state of a β-extrapolation is its moment set, the fields of
``DataCentralMoments``: ``xave``, ``uave``, ``du``, ``dxdu``, ``wsum`` and
the flags ``order``, ``central``, ``x_is_u``, ``xalpha``, ``val_ndim``.  An
lnΠ state (``x_is_u``, macrostate grid in the batch axes) also carries the
fields of its ``lnPiDataCallback``: ``lnPi0``, ``mudotN`` and
``allow_resample``.  Both packages read and write it as numpy arrays, so a
state reduced by one predicts in the other.

A streaming state is such a moment state, or the tuple ``(mean, replicates,
chunk counter)`` of two of them and an integer; the streaming perturbation
state is the tuple ``(m, num, den[, bnum, bden, chunk counter])`` of arrays.
:func:`state_to_numpy` and :func:`state_from_numpy` carry any of them.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import DataCallback, DataCentralMoments
from .lnpi import lnPiDataCallback
from .utils.device import default_device

__all__ = [
    "FIELDS",
    "FLAGS",
    "LNPI_FIELDS",
    "data_from_numpy",
    "data_to_numpy",
    "state_from_numpy",
    "state_to_numpy",
]

FIELDS = ("xave", "uave", "du", "dxdu", "wsum")
FLAGS = ("order", "central", "x_is_u", "xalpha", "val_ndim")
LNPI_FIELDS = ("lnPi0", "mudotN")


def data_from_numpy(
    fields: dict,
    *,
    order: int,
    central: bool = True,
    x_is_u: bool = False,
    xalpha: bool = False,
    val_ndim: int = 0,
    device=None,
    dtype=None,
) -> DataCentralMoments:
    """Build the port's :class:`DataCentralMoments` from numpy arrays of its
    fields, on ``device`` (the default device when None), cast to ``dtype``
    when given.
    ``lnPi0`` and ``mudotN`` among the fields (and ``allow_resample``) give
    it an :class:`.lnpi.lnPiDataCallback`."""
    missing = [name for name in FIELDS if name not in fields]
    if missing:
        msg = f"missing moment fields {missing}"
        raise ValueError(msg)
    device = default_device() if device is None else device
    tensors = {
        name: torch.as_tensor(np.array(fields[name]), device=device, dtype=dtype)
        for name in FIELDS
    }
    meta = DataCallback()
    if "lnPi0" in fields:
        lnpi = {name: torch.as_tensor(np.array(fields[name]), device=device) for name in LNPI_FIELDS}
        meta = lnPiDataCallback(**lnpi, allow_resample=bool(fields.get("allow_resample", False)))
    return DataCentralMoments(
        **tensors,
        meta=meta,
        order=int(order),
        central=bool(central),
        x_is_u=bool(x_is_u),
        xalpha=bool(xalpha),
        val_ndim=int(val_ndim),
    )


def data_to_numpy(data) -> dict:
    """The fields (numpy arrays) and flags of a moment state, the reverse of
    :func:`data_from_numpy`; works on either package's state."""
    out = {name: np.asarray(_host(getattr(data, name))) for name in FIELDS}
    out.update({name: getattr(data, name) for name in FLAGS})
    if all(hasattr(data.meta, name) for name in LNPI_FIELDS):
        out.update({name: np.asarray(_host(getattr(data.meta, name))) for name in LNPI_FIELDS})
        out["allow_resample"] = bool(data.meta.allow_resample)
    return out


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def state_to_numpy(state):
    """A streaming state of either package as numpy: a moment state becomes
    the dict of :func:`data_to_numpy`, a tuple the tuple of its converted
    members, an array a numpy array, and the chunk counter an int."""
    if isinstance(state, (tuple, list)):
        return tuple(state_to_numpy(member) for member in state)
    if all(hasattr(state, name) for name in FIELDS):
        return data_to_numpy(state)
    if isinstance(state, int):
        return state
    arr = np.asarray(_host(state))
    return int(arr) if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer) else arr


def state_from_numpy(state, *, device=None, dtype=None):
    """The port's streaming state from the output of :func:`state_to_numpy`,
    on ``device`` (the default device when None), floating-point members
    cast to ``dtype`` when given."""
    if isinstance(state, (tuple, list)):
        return tuple(state_from_numpy(member, device=device, dtype=dtype) for member in state)
    if isinstance(state, dict):
        flags = {name: state[name] for name in FLAGS}
        return data_from_numpy(state, **flags, device=device, dtype=dtype)
    if isinstance(state, (int, np.integer)):
        return int(state)
    device = default_device() if device is None else device
    return torch.as_tensor(np.array(state), device=device, dtype=dtype)

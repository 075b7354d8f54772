"""Moment state carried between the JAX package and the torch port.

The state of a β-extrapolation is its moment set, the fields of
``DataCentralMoments``: ``xave``, ``uave``, ``du``, ``dxdu``, ``wsum`` and
the flags ``order``, ``central``, ``x_is_u``, ``xalpha``, ``val_ndim``.
Both packages read and write it as numpy arrays, so a state reduced by one
predicts in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import DataCallback, DataCentralMoments

__all__ = ["FIELDS", "FLAGS", "data_from_numpy", "data_to_numpy"]

FIELDS = ("xave", "uave", "du", "dxdu", "wsum")
FLAGS = ("order", "central", "x_is_u", "xalpha", "val_ndim")


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
    fields, on ``device`` (CPU by default), cast to ``dtype`` when given."""
    missing = [name for name in FIELDS if name not in fields]
    if missing:
        msg = f"missing moment fields {missing}"
        raise ValueError(msg)
    tensors = {
        name: torch.as_tensor(np.array(fields[name]), device=device, dtype=dtype)
        for name in FIELDS
    }
    return DataCentralMoments(
        **tensors,
        meta=DataCallback(),
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
    return out


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a

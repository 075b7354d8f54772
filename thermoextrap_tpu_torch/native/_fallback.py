"""The plain float64 torch route of the native engine, on the CPU.

Runs where the C++ library cannot be built; same contracts as the
:mod:`..native` functions it stands in for (host arrays in, numpy float64
out).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(out):
    return tuple(o.numpy() for o in out)


def reduce_central(uv, xv, order, weight, val_ndim):
    from ..ops import moments

    return _np(moments.reduce_central_comoments(_t(uv), _t(xv), order, weight=_t(weight), val_ndim=val_ndim))


def reduce_raw(uv, xv, order, weight, val_ndim):
    from ..ops import moments

    return _np(moments.reduce_raw_comoments(_t(uv), _t(xv), order, weight=_t(weight), val_ndim=val_ndim))


def resample_central(uv, xv, freq, order, weight):
    from ..ops import resample

    return _np(resample.resample_central_comoments(_t(uv), _t(xv), _t(freq), order, weight=_t(weight)))

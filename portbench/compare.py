"""The numbers that decide ``correct``.

- ``pred_err``: the widest gap between a call's prediction and the
  reference's, as a share of the widest extrapolated change the reference
  predicts (``max |ref(beta) - ref(beta0)|`` over targets and entries).
- ``sigma_err``: the widest relative gap between a call's bootstrap
  standard deviation and the reference's on the same counts, each entry
  against the reference's, or against a thousandth of the largest where it
  is smaller (at ``beta0`` the lnPi series has no spread at all).

A prediction or deviation that is not finite, or of another size, reads
the largest float (``WORST``), so it fails every limit and stays a number
in the result line's JSON.
"""

from __future__ import annotations

import sys

import numpy as np

WORST = sys.float_info.max


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _like(got, want):
    """``got`` as float64 in ``want``'s shape (a value axis of length 1 may
    differ), or None where the sizes differ or a value is not finite."""
    got = np.asarray(got, dtype=np.float64)
    if got.size != want.size or not np.all(np.isfinite(got)):
        return None
    return got.reshape(want.shape)


def pred_err(pred, ref: dict) -> float:
    want = _np(ref["pred"])
    got = _like(pred, want)
    if got is None:
        return WORST
    scale = float(np.max(np.abs(want - _np(ref["c0"]))))
    return float(np.max(np.abs(got - want)) / scale)


def sigma_err(std, ref: dict) -> float:
    want = _np(ref["std"])
    got = _like(std, want)
    if got is None:
        return WORST
    floor = 1e-3 * float(np.max(want))
    if floor <= 0:
        return WORST
    return float(np.max(np.abs(got - want) / np.maximum(want, floor)))

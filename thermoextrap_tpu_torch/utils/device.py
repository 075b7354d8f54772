"""Where data that is not yet a tensor goes.

Entry points take numpy arrays, sequences and seeds as well as tensors.  A
tensor keeps its device; everything else lands on :func:`default_device`:
the first CUDA card when there is one, else the CPU, unless the caller chose
with :func:`set_default_device`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["HOST_READS", "default_device", "host_numpy", "is_dtensor", "set_default_device"]

_DEVICE: torch.device | None = None  # None = by availability

# reads back to the host of tensors on another device than the CPU, through
# host_numpy (the loops that read predictions back count theirs here)
HOST_READS = {"n": 0}


def default_device() -> torch.device:
    """The device of new tensors made from numpy arrays, sequences and seeds."""
    if _DEVICE is not None:
        return _DEVICE
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def set_default_device(device) -> None:
    """Choose the default device (``None`` restores the choice by availability)."""
    global _DEVICE
    _DEVICE = None if device is None else torch.device(device)


def host_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array: one read
    back from the card for a tensor there, counted in ``HOST_READS``."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            HOST_READS["n"] += 1
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_dtensor(a) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``; never imports that
    module (it loads sympy), since no DTensor exists before it is loaded."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(a, mod.DTensor)

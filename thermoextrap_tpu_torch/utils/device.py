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

from . import trace

__all__ = [
    "HOST_READS",
    "HOST_SYNCS",
    "default_device",
    "host_item",
    "host_numpy",
    "is_dtensor",
    "set_default_device",
    "to_device",
]

_DEVICE: torch.device | None = None  # None = by availability

# reads back to the host of tensors on another device than the CPU, through
# host_numpy and host_item (the loops that read predictions back count theirs
# here)
HOST_READS = trace.register("host_reads", {"n": 0})
# points where the host waits on the card: the reads of host_numpy and
# host_item and the blocking copies of host data onto a CUDA device of
# to_device
HOST_SYNCS = trace.register("host_syncs", {"n": 0})


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
    back from the card for a tensor there, counted in ``HOST_READS`` and
    ``HOST_SYNCS`` and timed as a ``te.sync`` span."""
    if isinstance(a, torch.Tensor):
        if a.device.type == "cpu":
            return a.detach().numpy()
        HOST_READS["n"] += 1
        HOST_SYNCS["n"] += 1
        with trace.span("te.sync"):
            return a.detach().cpu().numpy()
    return np.asarray(a)


def host_item(t: torch.Tensor):
    """``t.item()``: one value of a tensor read to the host (a loop's
    condition, a count).  From a tensor on a card, counted in ``HOST_READS``
    and ``HOST_SYNCS`` and timed as a ``te.sync`` span, as
    :func:`host_numpy`."""
    if t.device.type == "cpu":
        return t.item()
    HOST_READS["n"] += 1
    HOST_SYNCS["n"] += 1
    with trace.span("te.sync"):
        return t.item()


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)``.  Host data (not a
    tensor, or a CPU tensor) copied onto a CUDA device waits for the card's
    queue to drain (a blocking copy from pageable memory ends in a stream
    synchronize): such a copy is counted in ``HOST_SYNCS`` and timed as a
    ``te.sync`` span."""
    device = torch.device(device)
    if device.type != "cuda" or (isinstance(a, torch.Tensor) and a.device.type != "cpu"):
        return torch.as_tensor(a, dtype=dtype, device=device)
    HOST_SYNCS["n"] += 1
    with trace.span("te.sync"):
        return torch.as_tensor(a, dtype=dtype, device=device)


def is_dtensor(a) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``; never imports that
    module (it loads sympy), since no DTensor exists before it is loaded."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(a, mod.DTensor)

"""Where the derivative-GPR core computes.

The GPR's Gram matrices are tiny (tens of rows) and badly conditioned, so its
linear algebra runs in float64.  The JAX package pins it to the host CPU
because the TPU has no float64 Cholesky; the H100 has one, so here it runs on
:func:`.device.default_device` (the card when there is one).  Inside
:func:`host_f64` it runs on the CPU instead: the explicit way to ask for the
JAX package's split.  Nothing changes device on its own.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch

from .device import default_device

__all__ = ["compute_device", "host_f64"]

_HOST = contextvars.ContextVar("thermoextrap_tpu_torch_host_f64", default=False)


def compute_device() -> torch.device:
    """The device of the GPR core: the CPU inside :func:`host_f64`, else
    :func:`.device.default_device`."""
    return torch.device("cpu") if _HOST.get() else default_device()


@contextmanager
def host_f64():
    """Run the GPR core on the CPU (in float64, as always) inside the block."""
    token = _HOST.set(True)
    try:
        yield
    finally:
        _HOST.reset(token)

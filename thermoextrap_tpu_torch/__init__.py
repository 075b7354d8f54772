"""thermoextrap_tpu_torch: the thermoextrap_tpu system on PyTorch and CUDA.

The port of the JAX package ``thermoextrap_tpu`` to PyTorch, with the TPU's
Pallas kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``, built on
first use).  Module names mirror the JAX package.  This first slice carries
the β-extrapolation main path:

- (co)moment reduction and bootstrap (:mod:`.ops.moments`,
  :mod:`.ops.resample`, kernels in :mod:`.ops.moments_cuda`, routed by
  device in :mod:`.ops.dispatch`);
- the truncated-series derivative engine (:mod:`.ops.series`,
  :mod:`.models.derivatives`);
- data containers (:mod:`.data`), the Taylor model (:mod:`.models.extrap`),
  the β factories (:mod:`.beta`), the ideal-gas oracle (:mod:`.idealgas`),
  the serving pipeline (:mod:`.pipeline`) and the moment state shared with
  the JAX package (:mod:`.interop`).

Importing the package needs neither CUDA nor a compiler.
"""

from . import beta, data, idealgas, interop, pipeline
from .data import (
    DataCallback,
    DataCallbackABC,
    DataCentralMoments,
    DataCentralMomentsVals,
    DataValues,
    DataValuesCentral,
    factory_data_values,
)
from .models.derivatives import Derivatives
from .models.extrap import ExtrapModel

__version__ = "0.1.0"

__all__ = [
    "DataCallback",
    "DataCallbackABC",
    "DataCentralMoments",
    "DataCentralMomentsVals",
    "DataValues",
    "DataValuesCentral",
    "Derivatives",
    "ExtrapModel",
    "beta",
    "data",
    "factory_data_values",
    "idealgas",
    "interop",
    "pipeline",
]

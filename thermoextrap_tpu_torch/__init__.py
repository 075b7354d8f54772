"""thermoextrap_tpu_torch: the thermoextrap_tpu system on PyTorch and CUDA.

The port of the JAX package ``thermoextrap_tpu`` to PyTorch, with the TPU's
Pallas kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``, built on
first use).  Module names mirror the JAX package.  It carries the
β-extrapolation main path, the ensembles, perturbation reweighting, the
interpolation models and the streaming pipelines:

- (co)moment reduction and bootstrap (:mod:`.ops.moments`,
  :mod:`.ops.resample`, kernels in :mod:`.ops.moments_cuda`, routed by
  device in :mod:`.ops.dispatch`, with the compiled host engine of
  :mod:`.native` for host arrays on request);
- the truncated-series derivative engine (:mod:`.ops.series`,
  :mod:`.models.derivatives`);
- data containers, the streaming accumulator and its ``.npz`` checkpoint
  (:mod:`.data`), the Taylor, perturbation and collection models (weighted
  extrapolation and joint or piecewise interpolation between states,
  :mod:`.models.extrap`), the β factories (:mod:`.beta`), the ideal-gas
  oracle (:mod:`.idealgas`), the one-shot, streaming, streaming-interpolation
  and bucketed serving pipelines (:mod:`.pipeline`, with the perturbation
  bootstrap kernels K7 / K8), checkpoints of any state
  (:mod:`.utils.checkpoint`) and the states shared with the JAX package
  (:mod:`.interop`);
- the lnΠ macrostate-grid expansion (:mod:`.lnpi`) and the volume expansion
  (:mod:`.volume`, :mod:`.volume_idealgas`), with the batched u-moment
  kernels K4 / K5 behind the lnΠ and ⟨u⟩ paths;
- multistate reweighting (:mod:`.models.mbar`, ``MBARModel``);
- the ingest runtime (:mod:`.io_stream`: prefetched chunk streams from
  text and ``.npy`` files into the streaming pipelines, staged onto the
  card on a side stream) and the compiled host engines (:mod:`.native`:
  the table loader and the float64 moment engine, built with ``g++``);
- the adaptive and recursive interpolation trainers
  (:mod:`.adaptive_interp`, :mod:`.recursive_interp`), the GPR data staging
  (:mod:`.stack`), the labeled-array adapter (:mod:`.compat`) and the
  random-number seam (:mod:`.random`);
- gradients through the kernels K1, K2, K4 and K6
  (:mod:`.ops.moments_autograd`, taken by :mod:`.ops.dispatch` for inputs
  that require grad);
- derivative-informed GPR (:mod:`.gpr_active`, loaded on first use: the
  kernels, the heteroscedastic GP models in float64 on the card, the GP
  staging and builders, the ideal-gas harness) and its serving pipeline
  (``pipeline.make_gpr_pipeline``);
- sharding over a ``torch.distributed`` device mesh (:mod:`.parallel`: the
  sharded reductions, bootstraps and MBAR behind the pipelines' ``mesh=``,
  gloo on the CPU and NCCL on the card);
- serving artifacts (:mod:`.serving_export`, loaded on first use):
  pipelines traced once by ``torch.export`` into files that a serving
  process loads and calls on the CPU or the card without tracing.

Arrays that are not tensors go to :func:`default_device`: the CUDA card when
there is one, unless :func:`set_default_device` says otherwise.  Importing
the package needs neither CUDA nor a compiler.  ``__all__`` holds the JAX
package's names; ``default_device``, ``set_default_device`` and
:mod:`.interop` are the port's own, attributes outside it.
"""

from . import (
    adaptive_interp,
    beta,
    compat,
    data,
    idealgas,
    interop,
    io_stream,
    lnpi,
    parallel,
    pipeline,
    random,
    recursive_interp,
    stack,
    volume,
    volume_idealgas,
)
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
from .models.extrap import (
    ExtrapModel,
    ExtrapWeightedModel,
    InterpModel,
    InterpModelPiecewise,
    MBARModel,
    PerturbModel,
    StateCollection,
)
from .utils.device import default_device, set_default_device

__version__ = "0.1.0"


def __getattr__(name):
    # the GPR stack and the export module load on first use, as in the JAX
    # package
    if name in ("gpr_active", "serving_export"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)


__all__ = [
    "DataCallback",
    "DataCallbackABC",
    "DataCentralMoments",
    "DataCentralMomentsVals",
    "DataValues",
    "DataValuesCentral",
    "Derivatives",
    "ExtrapModel",
    "ExtrapWeightedModel",
    "InterpModel",
    "InterpModelPiecewise",
    "MBARModel",
    "PerturbModel",
    "StateCollection",
    "adaptive_interp",
    "beta",
    "compat",
    "data",
    "factory_data_values",
    "idealgas",
    "io_stream",
    "lnpi",
    "parallel",
    "pipeline",
    "random",
    "recursive_interp",
    "serving_export",
    "stack",
    "volume",
    "volume_idealgas",
]

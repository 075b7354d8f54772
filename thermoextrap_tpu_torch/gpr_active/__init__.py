"""Derivative-informed GPR (counterpart of ``thermoextrap_tpu.gpr_active``):
the kernels, the heteroscedastic GP models, the GP staging and builders, and
the ideal-gas harness.  The active-learning half (``active_learning``, the
``experimental`` noise GPs, ``serving`` and ``sine_active``) is not ported
yet; its names raise an ``ImportError`` that says so."""

from . import active_utils, gp_models, ig_active, kernels
from .active_utils import create_GPR, train_GPR
from .gp_models import (
    DerivativeKernel,
    HetGaussianSimple,
    HeteroscedasticGPR,
    HeteroscedasticGPRAnalyticalScale,
)
from .kernels import CallableDerivativeKernel, RBFDerivKernel

__all__ = [
    "CallableDerivativeKernel",
    "DerivativeKernel",
    "HetGaussianSimple",
    "HeteroscedasticGPR",
    "HeteroscedasticGPRAnalyticalScale",
    "RBFDerivKernel",
    "active_utils",
    "create_GPR",
    "gp_models",
    "ig_active",
    "kernels",
    "train_GPR",
]

# the JAX package's names that come with the active-learning half
_NOT_PORTED = (
    "FrozenGPRPredictor",
    "FullyHeteroscedasticGPR",
    "HetGaussianNoiseGP",
    "active_learning",
    "experimental",
    "freeze_predictor",
    "serving",
    "sine_active",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        msg = (
            f"{__name__}.{name} is not ported yet: it comes with the "
            "active-learning half of ROADMAP Queue 1 item 3"
        )
        raise ImportError(msg)
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)

"""Derivative-informed GPR and active learning (counterpart of
``thermoextrap_tpu.gpr_active``): the kernels, the heteroscedastic GP models,
the GP staging and builders, the update policies, stopping metrics and the
``active_learning`` loop, the experimental noise GPs, the frozen predictor of
``serving``, and the ideal-gas and sine harnesses."""

from . import (
    active_utils,
    experimental,
    gp_models,
    ig_active,
    kernels,
    serving,
    sine_active,
)
from .active_utils import active_learning, create_GPR, train_GPR
from .experimental import FullyHeteroscedasticGPR, HetGaussianNoiseGP
from .gp_models import (
    DerivativeKernel,
    HetGaussianSimple,
    HeteroscedasticGPR,
    HeteroscedasticGPRAnalyticalScale,
)
from .kernels import CallableDerivativeKernel, RBFDerivKernel
from .serving import FrozenGPRPredictor, freeze_predictor

__all__ = [
    "CallableDerivativeKernel",
    "DerivativeKernel",
    "FrozenGPRPredictor",
    "FullyHeteroscedasticGPR",
    "HetGaussianNoiseGP",
    "HetGaussianSimple",
    "HeteroscedasticGPR",
    "HeteroscedasticGPRAnalyticalScale",
    "RBFDerivKernel",
    "active_learning",
    "active_utils",
    "create_GPR",
    "experimental",
    "freeze_predictor",
    "gp_models",
    "ig_active",
    "kernels",
    "serving",
    "sine_active",
    "train_GPR",
]

"""Derivative engine and models of the torch port."""

from .derivatives import Derivatives
from .extrap import ExtrapModel, PerturbModel

__all__ = ["Derivatives", "ExtrapModel", "PerturbModel"]

"""Derivative engine and extrapolation model of the torch port."""

from .derivatives import Derivatives
from .extrap import ExtrapModel

__all__ = ["Derivatives", "ExtrapModel"]

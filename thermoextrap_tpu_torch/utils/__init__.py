"""Utilities of the torch port."""

from .device import default_device, set_default_device
from .random import validate_rng

__all__ = ["default_device", "set_default_device", "validate_rng"]

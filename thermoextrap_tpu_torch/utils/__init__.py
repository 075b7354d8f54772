"""Utilities of the torch port."""

from .compile_cache import enable_compilation_cache
from .device import default_device, set_default_device
from .random import validate_rng

__all__ = ["default_device", "enable_compilation_cache", "set_default_device", "validate_rng"]

"""Utilities of the torch port."""

from .compile_cache import enable_compilation_cache
from .device import default_device, set_default_device
from .random import validate_rng
from .trees import asdict, pytree_dataclass, replace

__all__ = [
    "asdict",
    "default_device",
    "enable_compilation_cache",
    "pytree_dataclass",
    "replace",
    "set_default_device",
    "validate_rng",
]

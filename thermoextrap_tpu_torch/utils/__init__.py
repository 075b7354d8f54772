"""Utilities of the torch port."""

from .random import validate_rng

__all__ = ["validate_rng"]

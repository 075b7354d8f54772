"""Moment, resampling and series operations of the torch port."""

from . import convert, moments, resample, series

__all__ = ["convert", "moments", "resample", "series"]

"""Moment, resampling and series operations of the torch port."""

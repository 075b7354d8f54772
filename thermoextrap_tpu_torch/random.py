"""Random-number seam: every stochastic entry point of the package takes a
``torch.Generator``, an integer seed or ``None`` (:func:`validate_rng`), and
:func:`split` makes independent generators from one.  The streams are
torch's, not the JAX package's keys, so equal seeds give other draws."""

from .utils.random import split, validate_rng

__all__ = ["split", "validate_rng"]

"""Shared type aliases (the torch forms of the JAX package's ``typing``)."""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Union

import numpy as np
import torch

ArrayLike = Union[torch.Tensor, np.ndarray, Sequence[float], float]
"""Anything convertible to a tensor."""

Sampler = Union[Mapping[str, Any], np.ndarray, torch.Tensor]
"""Bootstrap sampler spec: ``{"nrep": R}``, ``{"indices": ...}``,
``{"freq": ...}``, or a bare (nrep, nsamp) index array."""

CoefsFn = Callable[[tuple, int], torch.Tensor]
"""Derivative-engine coefficient function: ``(derivs_args, order) -> (order+1, ...)``."""

__all__ = ["ArrayLike", "CoefsFn", "Sampler"]

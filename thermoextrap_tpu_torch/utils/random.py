"""Random-number seam: every stochastic entry point of the package takes a
``torch.Generator``, an integer seed, or ``None`` (the fixed default seed)."""

from __future__ import annotations

import numpy as np
import torch

from .device import default_device

_DEFAULT_SEED = 0


def validate_rng(rng=None, device=None) -> torch.Generator:
    """Return a ``torch.Generator`` from a generator, an int seed or None.

    A seed builds a new generator on ``device`` (:func:`.device.default_device`
    when not given); a generator passes through unchanged.
    """
    if isinstance(rng, torch.Generator):
        return rng
    if rng is None:
        rng = _DEFAULT_SEED
    if isinstance(rng, (int, np.integer)) and not isinstance(rng, (bool, np.bool_)):
        gen = torch.Generator(device=default_device() if device is None else device)
        gen.manual_seed(int(rng))
        return gen
    msg = f"cannot interpret {rng!r} as a torch.Generator or an integer seed"
    raise TypeError(msg)

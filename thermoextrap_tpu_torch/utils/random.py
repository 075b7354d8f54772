"""Random-number seam: every stochastic entry point of the package takes a
``torch.Generator``, an integer seed, or ``None`` (the fixed default seed)."""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_SEED = 0


def validate_rng(rng=None, device=None) -> torch.Generator:
    """Return a ``torch.Generator`` from a generator, an int seed or None.

    A seed builds a new generator on ``device`` (CPU when not given); a
    generator passes through unchanged.
    """
    if isinstance(rng, torch.Generator):
        return rng
    if rng is None:
        rng = _DEFAULT_SEED
    if isinstance(rng, (int, np.integer)) and not isinstance(rng, (bool, np.bool_)):
        gen = torch.Generator(device=torch.device("cpu") if device is None else device)
        gen.manual_seed(int(rng))
        return gen
    msg = f"cannot interpret {rng!r} as a torch.Generator or an integer seed"
    raise TypeError(msg)

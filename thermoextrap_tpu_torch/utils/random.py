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


def split(rng=None, num: int = 2) -> list[torch.Generator]:
    """``num`` new generators on the device of ``validate_rng(rng)``, each
    seeded from one 63-bit draw of it (so ``rng`` advances).  The port's
    counterpart of ``jax.random.split``: the streams differ from the JAX
    package's keys at an equal seed."""
    gen = validate_rng(rng)
    seeds = torch.randint(0, 2**63 - 1, (int(num),), generator=gen, device=gen.device, dtype=torch.int64)
    out = []
    for seed in seeds.tolist():
        g = torch.Generator(device=gen.device)
        g.manual_seed(seed)
        out.append(g)
    return out

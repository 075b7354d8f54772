"""Heteroscedastic-sine data generator for GP / active-learning tests
(counterpart of ``thermoextrap_tpu/gpr_active/sine_active.py``).  The noise
is drawn from a ``torch.Generator`` (on the default device for a seed), so
the draws differ from the JAX package's at an equal seed."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import host_numpy
from ..utils.random import validate_rng

__all__ = ["make_data", "noise_func"]


def noise_func(x, s, n):
    """Heteroscedastic variance model ``n * (s*(x - min x) + cos(x)^2)``."""
    return n * (s * (x - np.min(x)) + np.cos(x) ** 2)


def make_data(
    x_vals,
    fac: float = 1.0,
    phase_shift: float = 0.0,
    noise: float = 0.1,
    slope: float = 0.1,
    order_scale: float = 1.0,
    max_order: int = 4,
    rng=None,
):
    """Noisy sine + derivatives with order-scaled heteroscedastic variance.
    Returns numpy ``(X, Y, Y_err)`` ready for
    :class:`~thermoextrap_tpu_torch.gpr_active.gp_models.HeteroscedasticGPR`.
    """
    gen = validate_rng(rng)
    x_vals = np.atleast_1d(np.asarray(x_vals, dtype=float))

    y_vals = fac * np.sin(x_vals + phase_shift)
    y_err = (fac**2) * noise_func(x_vals, slope, noise)
    for i in range(1, max_order + 1):
        deriv = fac * (np.sin(x_vals + phase_shift) if i % 2 == 0 else np.cos(x_vals + phase_shift))
        if i % 4 >= 2:
            deriv = -deriv
        this_noise = (fac**2) * noise_func(x_vals, slope, noise) * np.exp(order_scale * i)
        y_vals = np.hstack([y_vals, deriv])
        y_err = np.hstack([y_err, this_noise])

    x_mat = np.stack(
        [np.tile(x_vals, max_order + 1), np.repeat(np.arange(max_order + 1), x_vals.shape[0])],
        axis=1,
    )

    # both draws come back in one read
    draws = host_numpy(
        torch.cat(
            [
                torch.randn(y_vals.shape, generator=gen, device=gen.device, dtype=torch.float64),
                torch.rand(y_err.shape, generator=gen, device=gen.device, dtype=torch.float64),
            ]
        )
    )
    normal, uniform = draws[: y_vals.shape[0]], draws[y_vals.shape[0] :]
    y = y_vals + np.sqrt(y_err) * normal
    y_err_noisy = y_err * np.exp(0.5 * (uniform - 0.5))
    return x_mat, y[:, None], y_err_noisy[:, None]

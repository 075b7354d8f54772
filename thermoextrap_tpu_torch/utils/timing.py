"""Per-step device time by K-chain differencing, the port's counterpart of
``thermoextrap_tpu/utils/timing.py``.

One timed call of a step includes what is paid once per measurement: the
first launch, the synchronization, the clock's own reads.  The method:

1. chain ``K`` dependent calls of the step (each call takes the previous
   call's outputs), so the device runs all ``K`` in order;
2. time the chain on the device's own clock: CUDA events on the current
   stream for CUDA tensors, ``time.perf_counter`` around the chain on the
   CPU;
3. take the best of ``reps`` chains at each of two lengths and difference
   them (``K_hi - K_lo``), which removes the once-per-measurement costs.

Unlike the JAX ``fori_loop``, the chain here is a Python loop of eager
calls, so each step's host work and kernel-launch cost stays in the
number: it is the per-call cost a caller of the eager step pays.

A difference below :data:`NOISE_FLOOR_S` (per device type) carries more
than 10% noise: ten times the spread of the differenced time over repeated
measurements of a one-launch step (``_noise_floor``; on the card by
``chip_smoke.py`` phase 30, NVIDIA H100 80GB HBM3, 700.00 W).  Such a
result comes with a warning.
"""

from __future__ import annotations

import math
import time
import warnings

import torch

from .device import default_device

__all__ = ["kchain_time"]

# seconds: the largest floor of three runs of _noise_floor by chip_smoke.py
# phase 30 on an NVIDIA H100 80GB HBM3, 700.00 W (CUDA events: 140, 181 and
# 202 us, from a spread of 14.0-20.2 us over 16 launches of 11-16 us; the
# host clock of that machine: 25.6, 40.2 and 229 us, the last at the end of
# the whole script)
NOISE_FLOOR_S = {"cuda": 2.0e-4, "cpu": 2.3e-4}


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _chain_seconds(step, args: tuple, k: int, cuda: bool):
    """``(seconds, outputs)`` of ``k`` dependent calls of ``step``."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    out = args
    for _ in range(k):
        out = _as_tuple(step(*out))
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3, out
    return time.perf_counter() - t0, out


def kchain_time(step, args, k_lo: int = 4, k_hi: int = 20, reps: int = 3):
    """Per-call seconds of ``step``, K-chain differenced.

    Parameters
    ----------
    step : callable
        ``step(*args) -> args_like``: returns a tuple with the same
        structure as ``args`` (the chain's carry); a one-tensor step may
        return the bare tensor.
    args : tuple
        Initial operands.  Tensors keep their device; anything else becomes
        a tensor on :func:`.device.default_device`.
    k_lo, k_hi : chain lengths to difference.  Make the time difference
        larger than the device's :data:`NOISE_FLOOR_S`.
    reps : best-of repetitions per chain length (the least time of each
        length is taken before differencing).

    Returns
    -------
    ``(seconds_per_step, result)``: the differenced per-call time and the
    ``K_hi`` chain's final output (a tuple, for correctness checks).
    """
    if k_hi <= k_lo:
        msg = f"need k_hi > k_lo; got {k_lo=}, {k_hi=}"
        raise ValueError(msg)
    args = tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=default_device()) for a in args)
    cuda = any(a.is_cuda for a in args)
    # warm both lengths: first launches, kernel builds, allocator growth
    _chain_seconds(step, args, k_lo, cuda)
    _, result = _chain_seconds(step, args, k_hi, cuda)
    best = {}
    for k in (k_lo, k_hi):
        best[k] = min(_chain_seconds(step, args, k, cuda)[0] for _ in range(reps))
    dt = best[k_hi] - best[k_lo]
    floor = NOISE_FLOOR_S["cuda" if cuda else "cpu"]
    if dt < floor:
        warnings.warn(
            f"kchain_time delta {dt * 1e3:.3f} ms is below the {floor * 1e3:.3f} ms noise floor of "
            f"{'CUDA events' if cuda else 'the host clock'}; raise k_hi or the per-step work before "
            "trusting this rate",
            stacklevel=2,
        )
    return dt / (k_hi - k_lo), result


def _noise_floor(device, trials: int = 30, k_lo: int = 4, k_hi: int = 20) -> dict:
    """Measure the noise floor of :func:`kchain_time` on ``device``: the
    spread of the differenced time of a one-launch step (``x + 1`` on 16
    numbers) over ``trials`` measurements.  Returns the mean and standard
    deviation of that difference and ``floor_s`` = ten times the standard
    deviation, the delta at which one measurement's noise is 10%."""
    x = torch.zeros(16, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        deltas = [kchain_time(lambda a: a + 1.0, (x,), k_lo, k_hi)[0] * (k_hi - k_lo) for _ in range(trials)]
    mean = sum(deltas) / trials
    sd = math.sqrt(sum((d - mean) ** 2 for d in deltas) / (trials - 1))
    return {"device": str(torch.device(device)), "trials": trials, "delta_mean_s": mean, "delta_sd_s": sd, "floor_s": 10.0 * sd}

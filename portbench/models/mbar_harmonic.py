"""Pymbar's harmonic oscillators through the port's MBAR model: the pooled
samples, and the calls a traffic mix makes.

State ``k`` of ``states`` has ``sigma_k`` evenly spaced over
``sigma_range`` and the reduced potential ``u_k(x) = alpha_k x^2 / 2`` with
``alpha_k = 1 / sigma_k^2``.  Its ``samples_per_state`` samples are drawn on
the device from the seed, ``sigma_k`` times a standard normal, in the
configuration's ``dtype``, as one ``x (K, R)``.  A call reweights all of
them to ``targets`` spring constants ``alpha_a = 1 / sigma_a^2``,
``sigma_a`` evenly spaced over the same range, and answers ``<x>`` and
``<x^2>`` at each: ``(A, 2)``.
"""

from __future__ import annotations

import numpy as np
import torch

from thermoextrap_tpu_torch import DataValues, MBARModel, beta

SAMPLE_KEYS = ("x",)  # the inputs whose last axis is the samples


def _sigmas(cfg: dict, n: int) -> np.ndarray:
    lo, hi = cfg["sigma_range"]
    return np.linspace(float(lo), float(hi), int(n))


def state_alphas(cfg: dict) -> np.ndarray:
    return _sigmas(cfg, cfg["states"]) ** -2


def make_inputs(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    k, r = int(cfg["states"]), int(cfg["samples_per_state"])
    dtype = getattr(torch, cfg["dtype"])
    x = torch.randn((k, r), generator=gen, dtype=dtype, device=device)
    x.mul_(torch.as_tensor(_sigmas(cfg, k), dtype=dtype, device=device)[:, None])
    return {"x": x, "nrec": r, "betas": _sigmas(cfg, cfg["targets"]) ** -2}


def batch(cfg: dict, inputs: dict, nrep: int, *, control: bool = False):
    """``call(seed) -> (pred,)``: ``MBARModel(states).predict`` at every
    target, over one order-0 β model a state holding ``uv = x^2 / 2`` and
    ``xv = (x, x^2)``.  The control builds the states from ``uv`` and their
    ``alpha_k`` rounded to bfloat16, the nearest precision below float32
    (``uv`` alone is unbiased noise that the samples average away).  The
    model has no bootstrap to serve here."""
    if nrep:
        msg = "mbar_harmonic serves the point prediction alone (nrep 0)"
        raise ValueError(msg)
    x = inputs["x"]
    alpha0 = torch.as_tensor(state_alphas(cfg))
    if control:
        alpha0 = alpha0.to(torch.bfloat16).to(torch.float64)
    states = []
    for k in range(x.shape[0]):
        x2 = x[k] * x[k]
        uv = 0.5 * x2
        if control:
            uv = uv.to(torch.bfloat16).to(x.dtype)
        data = DataValues.from_vals(torch.stack([x[k], x2], dim=-1), uv, order=0)
        states.append(beta.factory_extrapmodel(float(alpha0[k]), data, order=0))
    alphas = inputs["betas"]

    def call(seed: int):
        return (MBARModel(states).predict(alphas),)

    return call


def entry_inputs(cfg: dict, inputs: dict, traffic: dict) -> dict:
    """The operands one call hands to MBAR's solve and its targets' grid:
    ``u_kn (K, N)``, ``n_k``, the pooled ``u_base (N,)`` and ``x_n (N, 2)``,
    and the targets, in the samples' type."""
    x = inputs["x"]
    dt, dev = x.dtype, x.device
    k, r = x.shape
    u = (0.5 * (x * x)).reshape(-1)
    return {
        "u_kn": torch.as_tensor(state_alphas(cfg), dtype=dt, device=dev)[:, None] * u,
        "n_k": torch.full((k,), float(r), dtype=dt, device=dev),
        "u_base": u,
        "x_n": torch.stack([x, x * x], dim=-1).reshape(-1, 2),
        "alphas": torch.as_tensor(inputs["betas"], dtype=dt, device=dev),
    }

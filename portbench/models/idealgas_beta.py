"""The ideal gas in a linear field through the port's beta-extrapolation
pipelines: the samples, and the calls a traffic mix makes.

The samples are made on the device from the seed by the inverse CDF of one
particle's position, ``-log(1 - (1 - e^{-beta L}) r) / beta`` for uniform
``r``, ``npart`` positions a configuration: ``u`` their sum and ``x`` their
mean, in the configuration's ``dtype``, drawn in blocks of about ``_ELEMS``
positions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thermoextrap_tpu_torch import pipeline

_ELEMS = 1 << 28  # positions drawn per call of the generator (1 GiB in float32)
SAMPLE_KEYS = ("u", "x")  # the inputs whose last axis is the samples


def make_inputs(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    r, npart = int(cfg["samples"]), int(cfg["npart"])
    beta, vol = float(cfg["beta0"]), float(cfg["vol"])
    c = 1.0 - math.exp(-beta * vol)
    dtype = getattr(torch, cfg["dtype"])
    u = torch.empty(r, dtype=dtype, device=device)
    x = torch.empty(r, dtype=dtype, device=device)
    block = max(1, _ELEMS // npart)
    for r0 in range(0, r, block):
        n = min(block, r - r0)
        pos = torch.rand((n, npart), generator=gen, dtype=dtype, device=device)
        torch.sum(pos.mul_(-c).log1p_(), dim=1, out=u[r0 : r0 + n])
        del pos
    u.mul_(-1.0 / beta)
    torch.div(u, npart, out=x)
    return {"u": u, "x": x, "nrec": r, "betas": np.asarray(cfg["betas"], dtype=np.float64)}


def batch(cfg: dict, inputs: dict, nrep: int, *, control: bool = False):
    """``call(seed) -> (pred,) or (pred, std)``: one call of
    ``make_extrap_pipeline`` on all the samples; the control streams them
    as bfloat16 (the pipeline's ``bf16`` path)."""
    run = pipeline.make_extrap_pipeline(int(cfg["order"]), float(cfg["beta0"]), nrep=nrep, bf16=control)
    u, x2, betas = inputs["u"], inputs["x"][:, None], inputs["betas"]

    def call(seed: int):
        out = run(u, x2, betas, seed=seed)
        return out if nrep else (out,)

    return call


def stream(cfg: dict, inputs: dict, nrep: int, chunks: int, *, control: bool = False):
    """``session(seed) -> (state, update(state, k), predict(state))``: a
    streaming pipeline at ``seed`` that folds chunk ``k`` of ``chunks``
    equal chunks of the samples."""
    r = inputs["u"].shape[0]
    if r % chunks:
        msg = f"{r} samples do not split into {chunks} equal chunks"
        raise ValueError(msg)
    uc = inputs["u"].view(chunks, -1)
    xc = inputs["x"].view(chunks, -1)
    betas = inputs["betas"]
    device = inputs["u"].device

    def session(seed: int):
        state0, update, predict = pipeline.make_streaming_extrap_pipeline(
            int(cfg["order"]), float(cfg["beta0"]), nrep=nrep, seed=seed, device=device, bf16=control
        )
        return state0, (lambda state, k: update(state, uc[k], xc[k])), (lambda state: predict(state, betas))

    return session


def entry_inputs(cfg: dict, inputs: dict, traffic: dict) -> dict:
    """The operands one call hands to the port's reductions: all the
    samples, or one chunk of a stream."""
    u, x = inputs["u"], inputs["x"]
    if traffic["mode"] == "stream":
        n = u.shape[0] // int(traffic["chunks"])
        u, x = u[:n], x[:n]
    return {"u": u, "x2": x[:, None], "order": int(cfg["order"]), "nrep": int(traffic["nrep"])}

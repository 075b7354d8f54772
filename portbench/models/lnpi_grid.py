"""A macrostate distribution lnPi(N) through the port's lnPi pipeline: the
grid of energy samples, and the calls a traffic mix makes.

The configuration's data file holds lnPi at ``beta0``, ``mu`` and each
macrostate's ``<u>`` and ``<u^2>``.  Each macrostate's samples are drawn on
the device from the seed, Gaussian with that mean and variance, in the
configuration's ``dtype``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from thermoextrap_tpu_torch import pipeline

_REPO = Path(__file__).resolve().parents[2]
SAMPLE_KEYS = ("uv",)  # the inputs whose last axis is the samples


def make_inputs(cfg: dict, seed: int, device) -> dict:
    data = json.loads((_REPO / cfg["data"]).read_text())
    mean = torch.tensor(data["u_mean"], dtype=torch.float64, device=device)
    var = torch.tensor(data["u2_mean"], dtype=torch.float64, device=device) - mean**2
    sd = var.clamp(min=0.0).sqrt()
    nbatch, n = mean.shape[0], int(cfg["samples_per_macrostate"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dtype = getattr(torch, cfg["dtype"])
    uv = torch.randn((nbatch, n), generator=gen, dtype=dtype, device=device)
    uv.mul_(sd.to(dtype)[:, None]).add_(mean.to(dtype)[:, None])
    return {
        "uv": uv,
        "lnpi0": torch.tensor(data["lnPi"], dtype=torch.float64, device=device),
        "mudotn": float(data["mu"]) * torch.arange(nbatch, dtype=torch.float64, device=device),
        "nrec": n,
        "betas": 1.0 / np.asarray(cfg["temps"], dtype=np.float64),
    }


def batch(cfg: dict, inputs: dict, nrep: int, *, control: bool = False):
    """``call(seed) -> (pred,) or (pred, std)``: one call of
    ``make_lnpi_pipeline`` over the grid; the control hands it the grid in
    bfloat16 (the kernels' bfloat16 stream)."""
    run = pipeline.make_lnpi_pipeline(int(cfg["order"]), float(cfg["beta0"]), nrep=nrep)
    uv = inputs["uv"].to(torch.bfloat16) if control else inputs["uv"]
    lnpi0, mudotn, betas = inputs["lnpi0"], inputs["mudotn"], inputs["betas"]

    def call(seed: int):
        out = run(uv, lnpi0, mudotn, betas, seed=seed)
        return out if nrep else (out,)

    return call


def entry_inputs(cfg: dict, inputs: dict, traffic: dict) -> dict:
    """The operands one call hands to the port's reductions."""
    return {"uv": inputs["uv"], "order": int(cfg["order"]), "nrep": int(traffic["nrep"])}

"""Derivative-informed GPR on ideal-gas states through the port's
``make_gpr_pipeline``: the states' samples, and the calls a traffic mix
makes.

State ``k`` of ``state_betas`` holds ``samples_per_state`` configurations
of the ideal gas in a linear field at ``beta_k``, drawn on the device by
``models/idealgas_beta.py``'s inverse-CDF sampler from a seed of its own
(``u`` the sum and ``x`` the mean of ``npart`` positions), as one ``u (K,
R)`` and one ``x (K, R)``.  A call is one iteration of upstream's active
learning: every state reduced to the derivatives of ``<x>`` to ``order``
with a ``boot_nrep``-replicate index-table bootstrap as its noise, one
fit, and the posterior at ``betas``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from portbench.generator import derive
from portbench.models import idealgas_beta
from thermoextrap_tpu_torch import DataCentralMomentsVals, beta, pipeline
from thermoextrap_tpu_torch.gpr_active import active_utils

SAMPLE_KEYS = ("u", "x")  # the inputs whose last axis is the samples
_STATES = 6  # the key of each state's sampling seed


def make_inputs(cfg: dict, seed: int, device) -> dict:
    r, betas0 = int(cfg["samples_per_state"]), [float(b) for b in cfg["state_betas"]]
    dtype = getattr(torch, cfg["dtype"])
    u = torch.empty((len(betas0), r), dtype=dtype, device=device)
    x = torch.empty_like(u)
    for k, b in enumerate(betas0):
        one = {"samples": r, "npart": cfg["npart"], "beta0": b, "vol": cfg["vol"], "dtype": cfg["dtype"], "betas": []}
        drawn = idealgas_beta.make_inputs(one, derive(seed, _STATES, k), device)
        u[k], x[k] = drawn["u"], drawn["x"]
        del drawn
    return {"u": u, "x": x, "nrec": r, "betas": np.asarray(cfg["betas"], dtype=np.float64)}


def batch(cfg: dict, inputs: dict, nrep: int, *, control: bool = False):
    """``call(seed) -> (pred,)``: ``make_gpr_pipeline`` on one
    ``DataCentralMomentsVals`` β state a state, then its ``predict`` at
    ``betas``; ``pred (A, 2)`` holds the posterior mean of ``<x>`` and
    ``log_sigma_weight`` times the log of its deviation (see
    ``reference/gpr_idealgas.predict``).  The bootstrap tables come from one
    generator on the samples' device, seeded with ``table_seed`` at the
    start of every call, so every call answers the same and the seed a call
    is given is not read.  The control builds the states from samples
    rounded to bfloat16, the nearest precision below float32."""
    if nrep:
        msg = "gpr_idealgas serves the point prediction alone (nrep 0): its bootstrap is the GP's noise model"
        raise ValueError(msg)
    u, x = inputs["u"], inputs["x"]
    if control:
        u, x = (t.to(torch.bfloat16).to(t.dtype) for t in (u, x))
    staged = inspect.signature(active_utils.input_GP_from_state).parameters["n_rep"].default
    if int(cfg["boot_nrep"]) != staged:
        msg = f"make_gpr_pipeline stages {staged} bootstrap replicates a state, not {cfg['boot_nrep']}"
        raise ValueError(msg)
    order, betas0 = int(cfg["order"]), [float(b) for b in cfg["state_betas"]]
    table_seed, weight = int(cfg["table_seed"]), float(cfg["log_sigma_weight"])
    betas = inputs["betas"]
    gen = torch.Generator(device=u.device)

    def call(seed: int):
        states = [
            beta.factory_extrapmodel(b, DataCentralMomentsVals.from_vals(x[k][:, None], u[k], order=order))
            for k, b in enumerate(betas0)
        ]
        gen.manual_seed(table_seed)
        _gpr, predict = pipeline.make_gpr_pipeline(states, rng=gen)
        mean, var = predict(betas)
        return (torch.as_tensor(np.column_stack([mean[:, 0], weight * 0.5 * np.log(var[:, 0])])),)

    return call


def entry_inputs(cfg: dict, inputs: dict, traffic: dict) -> dict:
    """The operands of one state's count-table bootstrap: the first state's
    ``u`` and ``x (R, 1)``, the order, the replicates and a table seed."""
    return {
        "u": inputs["u"][0],
        "x2": inputs["x"][0][:, None],
        "order": int(cfg["order"]),
        "boot_nrep": int(cfg["boot_nrep"]),
        "table_seed": int(cfg["table_seed"]),
    }

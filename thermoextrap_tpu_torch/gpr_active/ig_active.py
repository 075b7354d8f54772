"""Ideal-gas harnesses for the GP and active-learning paths (counterpart of
``thermoextrap_tpu/gpr_active/ig_active.py``): the "fake simulator".  Data
is drawn with a ``torch.Generator`` on the default device, so on a machine
with a card each state's samples are made there and reduced by K1."""

from __future__ import annotations

import torch

from .. import beta as xpan_beta
from .. import idealgas
from ..data import DataCentralMomentsVals
from ..utils.random import split, validate_rng
from .active_utils import DataWrapper

__all__ = ["IG_DataWrapper", "SimulateIG", "extrap_IG", "multiOutput_extrap_IG"]


def extrap_IG(beta, rng=None, nconfig: int = 10_000, npart: int = 1_000, order: int = 3):  # noqa: N802
    """Extrapolation state on fresh IG data."""
    y, u = idealgas.generate_data((nconfig, npart), beta, rng=validate_rng(rng))
    data = DataCentralMomentsVals.from_vals(y[:, None], u, order=order)
    return xpan_beta.factory_extrapmodel(beta, data)


def multiOutput_extrap_IG(beta, rng=None, nconfig: int = 10_000, npart: int = 1_000):  # noqa: N802
    """Two-output (x, x^2) IG state."""
    positions = idealgas.x_sample((nconfig, npart), beta, rng=validate_rng(rng))
    y = positions.mean(dim=-1)
    ysq = (positions**2).mean(dim=-1)
    u = positions.sum(dim=-1)
    data = DataCentralMomentsVals.from_vals(torch.stack([y, ysq], dim=1), u, order=3)
    return xpan_beta.factory_extrapmodel(beta, data)


class IG_DataWrapper(DataWrapper):  # noqa: N801 - reference name
    """Analytic 'simulation': fresh IG data at each request.  Each request
    splits the generator (:func:`..random.split`, where the JAX package
    splits a key) and draws from one half."""

    def __init__(self, beta, rng=None, nconfig: int = 10_000, npart: int = 1_000) -> None:
        self.beta = float(beta)
        self.rng = validate_rng(rng)
        self.nconfig = nconfig
        self.npart = npart

    def load_U_info(self):  # noqa: N802
        raise NotImplementedError

    def load_CV_info(self):  # noqa: N802
        raise NotImplementedError

    def load_x_info(self):
        raise NotImplementedError

    def get_data(self):
        """``(u, x[:, None], ones)`` as tensors on the generator's device."""
        self.rng, sub = split(self.rng)
        x, u = idealgas.generate_data((self.nconfig, self.npart), self.beta, rng=sub)
        return u, x[:, None], torch.ones_like(u)

    def build_state(self, all_data=None, max_order: int = 6):
        if all_data is None:
            all_data = self.get_data()
        u, x, _w = all_data
        data = DataCentralMomentsVals.from_vals(x, u, order=max_order)
        return xpan_beta.factory_extrapmodel(self.beta, data)


class SimulateIG:
    """Fake simulator returning fresh analytic IG data."""

    def __init__(self, sim_func=None, nconfig: int = 10_000, npart: int = 1_000) -> None:
        self.sim_func = sim_func
        self.nconfig = nconfig
        self.npart = npart
        self._counter = 0

    def run_sim(self, unused, beta, n_repeats=None, **_kws):
        del unused
        self._counter += 1
        return IG_DataWrapper(beta, rng=self._counter, nconfig=self.nconfig, npart=self.npart)

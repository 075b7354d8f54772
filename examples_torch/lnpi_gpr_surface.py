"""GPR surface model over macrostate distributions (lnPi) vs temperature, on the port.

The PyTorch form of ``examples/lnpi_gpr_surface.py`` (the reference notebooks
examples/usage/gpr/LJ_lnPi.ipynb and SWF_Adsorption.ipynb) on an
analytically solvable system: a grand-canonical ideal gas of non-interacting
particles in the 1D linear field (vol=1), where

    lnPi(N; beta) - lnPi(0; beta) = beta*mu*N + N*ln q1(beta) - ln N!
    q1(beta) = (1 - exp(-beta)) / beta

exactly.  The workflow is the notebook's:

  1. at each reference temperature, "simulate" independent runs producing
     per-macrostate raw energy moments (numpy draws of
     ``np.random.default_rng(3)``, the reference script's very draws),
  2. build a lnPi extrapolation state per temperature
     (``DataCentralMoments.from_ave_raw(x_is_u=True)`` + ``lnPiDataCallback``),
  3. assemble (x, y, cov) GP inputs per state, dropping the zero-variance
     N=0 bin,
  4. train one multi-output derivative-informed GPR over beta
     (``active_utils.create_GPR``) and predict the full lnPi(N) surface with
     uncertainty at unsimulated temperatures,
  5. smooth one predicted lnPi(N) curve with a second GP over the N axis
     using a constrained (p=0) likelihood, so the provided covariance is
     used as-is.

Every prediction is gated against the closed form above.  The moments come
pre-computed, so no kernel runs; the GPs work in float64.

Run: python examples_torch/lnpi_gpr_surface.py          (CUDA card, full size)
     python examples_torch/lnpi_gpr_surface.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import math

import numpy as np

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import lnpi
from thermoextrap_tpu_torch.gpr_active import active_utils
from thermoextrap_tpu_torch.utils.trees import replace

MU = -1.5  # chemical potential (constant across states, the notebook's ref_mu)
ORDER = 3  # raw moments k=0..ORDER+1 -> lnPi model order ORDER+1
BETAS_REF = [1.2, 2.8]
BETAS_TEST = [1.6, 2.0, 2.4]


def sizes(smoke: bool) -> tuple[int, int, int]:
    """``(nmax, nrun, nsamp)``: macrostates, runs and samples of a run."""
    return (6, 6, 1_500) if smoke else (10, 10, 20_000)


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def lnq1(beta):
    """Single-particle partition function ln q1 = ln[(1-e^-beta)/beta]."""
    return np.log(-np.expm1(-beta)) - np.log(beta)


def lnpi_exact(nvals, beta):
    """Exact lnPi(N;beta) - lnPi(0;beta) for the GC ideal gas."""
    nvals = np.asarray(nvals, dtype=float)
    lnfact = np.array([math.lgamma(n + 1.0) for n in nvals])
    return beta * MU * nvals + nvals * lnq1(beta) - lnfact


def simulate_energy_moments(beta, nmax, nrun, nsamp, order, rng):
    """Raw energy moments <U_N^k>, k=0..order, per run per macrostate.

    U_N = sum of N iid single-particle energies x ~ exp(-beta x) on [0,1]
    (inverse-CDF draws).  Returns ``(order+1, nrun, nmax+1)`` with the moment
    axis leading.
    """
    r = rng.random((nrun, nsamp, nmax))
    x = -np.log1p(-r * -np.expm1(-beta)) / beta
    # U over the macrostate grid: cumulative sums give U_N for N=0..nmax
    u = np.concatenate([np.zeros((nrun, nsamp, 1)), np.cumsum(x, axis=-1)], axis=-1)
    return np.stack([np.mean(u**k, axis=1) for k in range(order + 1)], axis=0)


def state_moments(smoke: bool) -> list:
    """The raw energy moments of each reference temperature, in draw order."""
    nmax, nrun, nsamp = sizes(smoke)
    rng = np.random.default_rng(3)
    return [simulate_energy_moments(b, nmax, nrun, nsamp, ORDER + 1, rng) for b in BETAS_REF]


def build_states(smoke: bool) -> list:
    """Steps 1-2: a lnPi extrapolation state per reference temperature."""
    nmax, nrun, _ = sizes(smoke)
    nvals = np.arange(nmax + 1, dtype=float)
    states = []
    for b, u_mom in zip(BETAS_REF, state_moments(smoke)):
        data = xt.DataCentralMoments.from_ave_raw(u=u_mom, xu=None, x_is_u=True, central=True)
        meta = lnpi.lnPiDataCallback.from_mu(
            lnPi0=np.broadcast_to(lnpi_exact(nvals, b), (nrun, nmax + 1)).copy(),
            mu=[MU],
            ncoords=np.broadcast_to(nvals, (nrun, nmax + 1))[None].copy(),
        )
        states.append(lnpi.factory_extrapmodel_lnPi(b, replace(data, meta=meta)))
    return states


class StatelnPi:
    """GP input holder for one temperature (LJ_lnPi.ipynb cell 5): slices
    the zero-variance N=0 bin out of ``input_GP_from_state``'s assembly so
    the block-diagonal noise stays non-singular."""

    def __init__(self, state) -> None:
        x, y, cov = active_utils.input_GP_from_state(state)
        self.x, self.y, self.cov = x, y[:, 1:], cov[1:]

    def __call__(self):
        return self.x, self.y, self.cov


def main(smoke: bool = SMOKE) -> dict:
    nmax, _, _ = sizes(smoke)
    nvals = np.arange(nmax + 1, dtype=float)
    states = build_states(smoke)

    # steps 3-4: multi-output GPR over (beta, deriv-order) inputs
    gp = active_utils.create_GPR([StatelnPi(s) for s in states])
    x_test = np.stack([np.asarray(BETAS_TEST, dtype=float), np.zeros(len(BETAS_TEST))], axis=1)
    gp_mu, gp_var = (_np(a) for a in gp.predict_f(x_test))
    gp_std = np.sqrt(gp_var)

    print(f"{'beta':>5} {'max|err|':>9} {'max std':>9}")
    surface_err = 0.0
    for i, b in enumerate(BETAS_TEST):
        exact = lnpi_exact(nvals[1:], b)
        err = float(np.max(np.abs(gp_mu[i] - exact)))
        surface_err = max(surface_err, err)
        print(f"{b:5.2f} {err:9.2e} {np.max(gp_std[i]):9.2e}")
        if not (err < 0.15 and np.all(np.abs(gp_mu[i] - exact) < 8 * gp_std[i] + 0.05)):
            raise SystemExit(f"lnPi surface at beta={b}: max err {err}")

    # step 5: GP over the N axis at one test temperature, covariance
    # constrained (p=0) so it is used verbatim (LJ_lnPi.ipynb cells 12-14)
    i_mid = len(BETAS_TEST) // 2
    x_in = np.stack([nvals[1:], np.zeros(nmax)], axis=1)
    y_in = gp_mu[i_mid][:, None]
    cov_in = np.diag(gp_var[i_mid])
    bin_gp = active_utils.create_base_GP_model(
        (x_in, y_in, cov_in),
        likelihood_kwargs={"p": 0.0, "transform_p": "none", "constrain_p": True},
    )
    active_utils.train_GPR(bin_gp)
    bin_mu, _ = (_np(a) for a in bin_gp.predict_f(x_in))
    exact_mid = lnpi_exact(nvals[1:], BETAS_TEST[i_mid])
    bin_err = float(np.max(np.abs(bin_mu[:, 0] - exact_mid)))
    print(f"N-axis GP at beta={BETAS_TEST[i_mid]}: max|err| = {bin_err:.2e}")
    if not bin_err < 0.2:
        raise SystemExit(f"N-axis GP error too large: {bin_err}")
    return {"surface_max_abs_err": surface_err, "n_axis_max_abs_err": bin_err}


if __name__ == "__main__":
    run(main, "lnpi_gpr_surface")

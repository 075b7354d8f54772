"""Temperature interpolation: the full model family side by side, on the port.

The PyTorch form of ``examples/temperature_interp.py`` (the reference
notebook examples/usage/basic/Temperature_Interp.ipynb): from samples at a
few reference inverse temperatures, predict <x>(beta) across the bracket
with every interpolation and reweighting model of the package -

- ``ExtrapWeightedModel``  - Minkowski-weighted blend of bracketing
  extrapolations,
- ``InterpModel``          - one joint polynomial through all states,
- ``InterpModelPiecewise`` - pairwise joint polynomials,
- ``MBARModel``            - multistate reweighting,
- ``PerturbModel``         - single-state exponential reweighting,

all compared with the analytic ideal-gas result.  At full size the
reweighting models degrade away from the sampled beta (overlap vanishes as
exp(-dbeta U) concentrates on a handful of samples), while the
derivative-based interpolations stay closer; at the sampled beta the joint
interpolation is held to the exact answer within 5 bootstrap sigma.  On the card each state's moments come from K1
and the collection's bootstrap from K6.

Run: python examples_torch/temperature_interp.py          (CUDA card, full size)
     python examples_torch/temperature_interp.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import numpy as np

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import beta, idealgas


def main(smoke: bool = SMOKE) -> dict:
    order = 4
    betas_ref = [1.0, 3.0, 5.0]
    betas_eval = np.linspace(1.0, 5.0, 9)
    shape = (2_000, 100) if smoke else (50_000, 1_000)

    states, raw = [], {}
    for i, b in enumerate(betas_ref):
        x, u = idealgas.generate_data(shape, b, rng=i)
        raw[b] = (u, x)
        data = xt.factory_data_values(uv=u, xv=x, order=order, central=True)
        states.append(beta.factory_extrapmodel(b, data))

    weighted = xt.ExtrapWeightedModel(states)
    interp = xt.InterpModel(states)
    piecewise = xt.InterpModelPiecewise(states)
    mbar = xt.MBARModel(states)
    perturb = beta.factory_perturbmodel(betas_ref[0], *raw[betas_ref[0]])

    cols = ["weighted", "interp", "piecewise", "mbar", "perturb(b0)", "exact"]
    print(f"{'beta':>6} " + " ".join(f"{c:>12}" for c in cols))
    interp_err = 0.0
    for b in betas_eval:
        vals = [
            float(weighted.predict(b)),
            float(interp.predict(b)),
            float(piecewise.predict(b)),
            float(mbar.predict(b)),
            float(perturb.predict(b)),
            float(idealgas.x_ave(b)),
        ]
        print(f"{b:6.2f} " + " ".join(f"{v:12.6f}" for v in vals))
        interp_err = max(interp_err, abs(vals[1] - vals[-1]))

    # bootstrap uncertainty works on the collections too (resample passes
    # through to every member state)
    boot = weighted.resample({"nrep": 10 if smoke else 50})
    mid = 0.5 * (betas_ref[0] + betas_ref[-1])
    ci = float(boot.predict(mid).std())
    print(f"\nweighted model at beta={mid:.2f}: +/- {ci:.2e} (bootstrap std)")
    # at each sampled beta the joint interpolation passes through the state's
    # sample mean: within a few bootstrap sigma of the exact <x>
    zmax = max(abs(float(interp.predict(b)) - float(idealgas.x_ave(b))) / float(boot.predict(b).std()) for b in betas_ref)
    if not zmax < 5.0:
        raise SystemExit(f"joint interpolation {zmax:.1f} bootstrap sigma off the exact <x> at a sampled beta")
    return {"max_z_at_sampled_beta": zmax, "interp_max_abs_err": interp_err, "weighted_ci_mid": ci}

if __name__ == "__main__":
    run(main, "temperature_interp")

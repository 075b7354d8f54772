"""The four temperature-extrapolation cases of the reference tutorial, on the port.

The PyTorch form of ``examples/beta_extrap_cases.py`` (the reference
notebooks examples/usage/basic/Temperature_Extrap_Case{1,2,3,4}.ipynb) on
the 1D ideal gas in a linear field, where every case has an exact analytic
answer (``thermoextrap_tpu_torch.idealgas``):

  Case 1 - temperature-INDEPENDENT observable <x>          (baseline)
  Case 2 - temperature-DEPENDENT observable  <beta * x>    (xalpha=True:
           xv carries explicit beta-derivative columns on a deriv axis)
  Case 3 - negative log of an average        -log<x>       (minus_log=True)
  Case 4 - both combined                     -log<beta*x>

Cases 2-4 are flags on the same data factory and predict call.  Each
prediction must lie within 6 bootstrap sigma of the exact truncated series.
On the card the moments come from K1 and the bootstraps from K6.

Run: python examples_torch/beta_extrap_cases.py          (CUDA card, full size)
     python examples_torch/beta_extrap_cases.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import numpy as np
import torch

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import beta, idealgas


def main(smoke: bool = SMOKE) -> dict:
    order = 4
    beta0 = 5.6
    betas_eval = np.array([beta0 - 0.4, beta0 + 0.4])
    nrep = 20 if smoke else 100
    shape = (2_000, 100) if smoke else (50_000, 1_000)

    x, u = idealgas.generate_data(shape, beta0, rng=7)

    # plain observable data (cases 1 & 3)
    data_plain = xt.factory_data_values(uv=u, xv=x[:, None], order=order, central=True)
    model_plain = beta.factory_extrapmodel(beta0, data_plain)

    # beta-dependent observable beta*x (cases 2 & 4): xv gains a deriv axis
    # holding d^k(beta*x)/dbeta^k at fixed configuration - [beta0*x, x, 0, ...]
    deriv_vals = torch.zeros((x.shape[0], order + 1, 1), dtype=x.dtype, device=x.device)
    deriv_vals[:, 0, 0] = beta0 * x
    deriv_vals[:, 1, 0] = x
    data_dep = xt.factory_data_values(uv=u, xv=deriv_vals, order=order, central=True, xalpha=True)
    model_dep = beta.factory_extrapmodel(beta0, data_dep)

    cases = [
        ("1: <x>", model_plain, False, lambda b: idealgas.x_beta_extrap(order, beta0, b)[0]),
        ("2: <beta*x>", model_dep, False, lambda b: idealgas.x_beta_extrap_depend(order, beta0, b, 1.0)[0]),
        ("3: -log<x>", model_plain, True, lambda b: idealgas.x_beta_extrap_minuslog(order, beta0, b)[0]),
        ("4: -log<beta*x>", model_dep, True, lambda b: idealgas.x_beta_extrap_depend_minuslog(order, beta0, b, 1.0)[0]),
    ]

    print(f"{'case':>16} {'beta':>6} {'pred':>12} {'+/-':>9} {'exact(order)':>13}")
    zmax = 0.0
    for name, model, minus_log, exact_fn in cases:
        boot = model.resample({"nrep": nrep})
        for b in betas_eval:
            pred = float(model.predict(b, minus_log=minus_log).reshape(-1)[0])
            err = float(boot.predict(b, minus_log=minus_log).std())
            exact = float(exact_fn(b))
            print(f"{name:>16} {b:6.2f} {pred:12.6f} {err:9.1e} {exact:13.6f}")
            if not np.isfinite(pred) or abs(pred - exact) > 6 * err + 1e-6:
                msg = f"case {name} at beta={b}: {pred} vs exact {exact}"
                raise SystemExit(msg)
            zmax = max(zmax, abs(pred - exact) / err)
    return {"max_z_vs_exact": zmax}


if __name__ == "__main__":
    run(main, "beta_extrap_cases")

"""Temperature extrapolation / interpolation of the 1D ideal gas, on the port.

The PyTorch form of ``examples/beta_extrapolation.py`` (the reference
notebook examples/usage/basic/temperature_extrap.ipynb): generate samples at
two reference state points, build order-6 extrapolation models with
bootstrap uncertainty, and a joint polynomial interpolation between the two
states.  On the card each state's moments come from the fused reduction
(K1) and the bootstrap's ``(nrep, R)`` replicates from the batched one (K6).

Run: python examples_torch/beta_extrapolation.py          (CUDA card, full size)
     python examples_torch/beta_extrapolation.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import numpy as np

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import beta, idealgas
from thermoextrap_tpu_torch.models.extrap import InterpModel


def main(smoke: bool = SMOKE) -> dict:
    order = 6
    beta0, beta1 = 1.0, 5.0
    betas_eval = np.linspace(beta0, beta1, 9)
    shape = (2_000, 100) if smoke else (50_000, 1_000)

    states = []
    for i, b in enumerate([beta0, beta1]):
        x, u = idealgas.generate_data(shape, b, rng=i)
        data = xt.factory_data_values(uv=u, xv=x, order=order, central=True)
        states.append(beta.factory_extrapmodel(b, data))

    print(f"{'beta':>6} {'extrap(b0)':>12} {'+/-':>9} {'interp':>12} {'exact':>12}")
    interp = InterpModel(states)
    boot0 = states[0].resample({"nrep": 20 if smoke else 100})
    interp_err = 0.0
    for b in betas_eval:
        pred0 = float(states[0].predict(b))
        err0 = float(boot0.predict(b).std())
        pint = float(interp.predict(b))
        exact = float(idealgas.x_ave(b))
        print(f"{b:6.2f} {pred0:12.6f} {err0:9.1e} {pint:12.6f} {exact:12.6f}")
        interp_err = max(interp_err, abs(pint - exact))
        if b == beta0:
            z0 = abs(pred0 - exact) / err0
    # at beta0 the extrapolation is the sample mean: within a few bootstrap sigma
    if not z0 < 5.0:
        msg = f"extrapolation at beta0 is {z0:.1f} bootstrap sigma from the exact <x>"
        raise SystemExit(msg)
    return {"interp_max_abs_err": interp_err, "beta0_z": z0}


if __name__ == "__main__":
    run(main, "beta_extrapolation")

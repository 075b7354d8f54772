"""Multistate reweighting (MBAR) of the 1D ideal gas, on the port.

The PyTorch form of ``examples/mbar_reweighting.py`` (the reference's
MBARModel usage, which wraps pymbar): pool samples drawn at several
temperatures, solve the MBAR free-energy equations once with the
Newton/self-consistent hybrid, then evaluate <x> on a grid of target
temperatures in one batched call, against polynomial interpolation and the
analytic ideal-gas average.  On the card each state's moments come from K1;
the MBAR solve and its bootstrap are plain torch.

Run: python examples_torch/mbar_reweighting.py          (CUDA card, full size)
     python examples_torch/mbar_reweighting.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import numpy as np
import torch

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import beta, default_device, idealgas
from thermoextrap_tpu_torch.models.extrap import InterpModel, MBARModel
from thermoextrap_tpu_torch.models.mbar import mbar_covariance, mbar_fe_uncertainties, mbar_solve, mbar_solve_info


def main(smoke: bool = SMOKE) -> dict:
    betas_sampled = [0.5, 1.0, 2.0, 4.0]
    betas_eval = np.linspace(0.5, 4.0, 8)
    shape = (2_000, 50) if smoke else (100_000, 500)

    states = []
    for i, b in enumerate(betas_sampled):
        x, u = idealgas.generate_data(shape, b, rng=i)
        data = xt.factory_data_values(uv=u, xv=x, order=2, central=True)
        states.append(beta.factory_extrapmodel(b, data))

    mbar = MBARModel(states)
    interp = InterpModel(states)

    # solver diagnostics: the hybrid takes a handful of Newton steps where
    # the plain fixed point crawls
    uv = torch.stack([m.data.uv for m in states])
    u_kn = torch.as_tensor(betas_sampled, dtype=uv.dtype, device=uv.device)[:, None] * uv.reshape(1, -1)
    n_k = torch.full((len(states),), float(uv.shape[-1]), dtype=uv.dtype, device=uv.device)
    _, it_h, res_h = mbar_solve_info(u_kn, n_k, method="hybrid")
    print(f"MBAR hybrid solve: {int(it_h)} iters, residual {float(res_h):.1e}")
    if smoke or default_device().type == "cpu":
        # the fixed-point comparison crawls through thousands of iterations:
        # the CPU runs only
        _, it_s, res_s = mbar_solve_info(u_kn, n_k, method="sci")
        print(f"  vs plain fixed point: {int(it_s)} iters, residual {float(res_s):.1e}")

    # free energies of the sampled states with asymptotic uncertainties
    # (pymbar capability the reference discards)
    f_k = mbar_solve(u_kn, n_k)
    dfe = mbar_fe_uncertainties(mbar_covariance(u_kn, n_k, f_k))
    print("state free energies f_k - f_0 (+/- asymptotic):")
    for b, f, d in zip(betas_sampled, f_k.cpu().numpy(), dfe[0]):
        print(f"  beta={b:4.1f}  f={f:10.4f} +/- {d:.1e}")

    mb = mbar.predict(betas_eval).reshape(-1).cpu().numpy()
    _, std = mbar.predict_ci(betas_eval, nrep=8 if smoke else 64)
    std = std.reshape(-1).cpu().numpy()
    print(f"\n{'beta':>6} {'mbar':>12} {'+/-':>9} {'interp':>12} {'exact':>12}")
    for b, m, s in zip(betas_eval, mb, std):
        pint = float(interp.predict(b))
        exact = float(idealgas.x_ave(b))
        print(f"{b:6.2f} {m:12.6f} {s:9.1e} {pint:12.6f} {exact:12.6f}")

    err = float(np.max(np.abs(mb - [float(idealgas.x_ave(b)) for b in betas_eval])))
    print(f"\nmax |mbar - exact| = {err:.2e}")
    tol = 5e-2 if smoke else 5e-3
    if not err < tol:
        msg = f"MBAR reweighting off by {err:.2e} (tol {tol})"
        raise SystemExit(msg)
    return {"max_abs_err": err, "hybrid_iters": int(it_h), "hybrid_residual": float(res_h)}


if __name__ == "__main__":
    run(main, "mbar_reweighting")

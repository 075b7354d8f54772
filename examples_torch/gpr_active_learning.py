"""Derivative-informed GPR active learning on the ideal gas, on the port.

The PyTorch form of ``examples/gpr_active_learning.py`` (the reference's
examples/gpr_active_learning/run_active_IG.py): start from two state points,
iteratively fit a heteroscedastic derivative GPR and acquire new simulation
points where the model is most uncertain.  Then serve the trained model
through ``make_gpr_pipeline`` and ``freeze_predictor``.  On the card each
state's derivative inputs come from K1 (its moments) and K2 (its bootstrap
table), and the GP works in float64.  The GP mean must lie within
max(4 sigma, 1e-3) of the exact ideal-gas <x>.

Run: python examples_torch/gpr_active_learning.py          (CUDA card, full size)
     python examples_torch/gpr_active_learning.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import tempfile

import numpy as np

from thermoextrap_tpu_torch import idealgas
from thermoextrap_tpu_torch.gpr_active import active_utils as au
from thermoextrap_tpu_torch.gpr_active import ig_active
from thermoextrap_tpu_torch.gpr_active.serving import freeze_predictor
from thermoextrap_tpu_torch.pipeline import make_gpr_pipeline


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def main(smoke: bool = SMOKE) -> dict:
    nconfig, npart, grid, iters = (800, 120, 40, 1) if smoke else (5_000, 500, 200, 4)
    sim = ig_active.SimulateIG(nconfig=nconfig, npart=npart)
    update = au.UpdateALMbrute(rng=0, n_grid=grid)
    stop = au.StopCriteria([au.MaxRelGlobalVar(tol=0.02), au.MaxIter()], n_grid=grid)

    with tempfile.TemporaryDirectory() as tmp:
        data_list, history = au.active_learning(
            [0.5, 2.5],
            sim,
            update,
            base_dir=tmp,
            stop_criteria=stop,
            max_iter=iters,
            max_order=3,
        )

    print("acquired state points:", sorted(float(d.beta) for d in data_list))
    print("losses:", [round(float(v), 2) for v in history["loss"]])

    states = [d.build_state(max_order=3) for d in data_list]
    gpr = au.create_GPR(states)
    xt = np.linspace(0.6, 2.4, 7)
    mu, var = (_np(a) for a in gpr.predict_f(np.stack([xt, np.zeros_like(xt)], axis=1)))
    print(f"{'beta':>6} {'GP mean':>10} {'GP std':>9} {'exact':>10}")
    worst = 0.0
    for b, m, v in zip(xt, mu[:, 0], var[:, 0]):
        exact = float(idealgas.x_ave(b))
        print(f"{b:6.2f} {m:10.5f} {np.sqrt(v):9.1e} {exact:10.5f}")
        worst = max(worst, abs(m - exact) / max(4.0 * np.sqrt(v), 1e-3))
    if not worst <= 1.0:
        raise SystemExit(f"GP mean off the exact <x> by {worst:.2f} of max(4 sigma, 1e-3)")

    # serving: the same trained model behind a bucketed closure - ragged
    # query-grid sizes reuse one padded predict shape
    _, predict = make_gpr_pipeline(states, bucket=16)
    for grid_n in (3, 5, 11):
        m, _ = predict(np.linspace(0.7, 2.3, grid_n))
        print(f"serving predict n={grid_n:2d}: mean[0]={float(_np(m)[0, 0]):.5f}")

    # frozen serving: the float64 solves fold into constants; prediction is
    # plain matrix products in float32, against the float64 predict_f
    frozen = freeze_predictor(gpr)
    fm, _fv = frozen(xt)
    err = float(np.max(np.abs(_np(fm)[:, 0] - mu[:, 0])))
    print(f"frozen f32 predictor: max |mean - predict_f| = {err:.1e}")
    return {"gp_err_over_bar": worst, "frozen_max_abs_diff": err, "n_states": len(states)}


if __name__ == "__main__":
    run(main, "gpr_active_learning")

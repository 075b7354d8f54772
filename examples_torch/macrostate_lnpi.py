"""Macrostate-distribution (lnPi) temperature extrapolation, on the port.

The PyTorch form of ``examples/macrostate_lnpi.py`` (the reference example
examples/usage/basic/macrostate_dist_extrap.ipynb) on the golden sample data
shipped with the tests: extrapolate lnPi from T=0.73 to other temperatures
and compare with the stored analytic extrapolations.  The moments come
pre-computed from the file, so no kernel runs; the model works in float64
on the default device.

Run: python examples_torch/macrostate_lnpi.py          (CUDA card, full size)
     python examples_torch/macrostate_lnpi.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import json

import numpy as np

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import lnpi
from thermoextrap_tpu_torch.utils.trees import replace

DATA = Path(__file__).resolve().parent.parent / "tests" / "lnpi_data" / "sample_data.json"
ERR_BAR = 1e-8  # float64 against the stored analytic extrapolations


def main(smoke: bool = SMOKE) -> dict:
    with DATA.open() as f:
        d = json.load(f)

    ref = d["ref"]
    lnpi0 = np.array(ref["lnPi"])
    lnpi0 -= lnpi0[0]
    energy = np.array(ref["energy"])  # (n_macrostate, umom 1..3)
    energy = np.concatenate([np.ones_like(energy[:, :1]), energy], axis=-1)

    data = xt.DataCentralMoments.from_ave_raw(u=energy.T, xu=None, x_is_u=True, central=True)
    meta = lnpi.lnPiDataCallback.from_mu(
        lnPi0=lnpi0,
        mu=[ref["mu"]],
        ncoords=np.arange(len(lnpi0), dtype=float)[None, :],
    )
    model = lnpi.factory_extrapmodel_lnPi(ref["beta"], replace(data, meta=meta))

    errs = []
    for s in d["samples"][: (2 if smoke else 4)]:
        pred = model.predict(s["beta"], cumsum=True)[s["order"]].cpu().numpy()
        pred = pred - pred[0]
        gold = np.array(s["lnPi"])
        gold -= gold[0]
        err = float(np.max(np.abs(pred - gold)))
        errs.append(err)
        print(f"T={s['temp']:.3f} order={s['order']}: max |lnPi error| = {err:.2e}")
    if not max(errs) < ERR_BAR:
        msg = f"lnPi extrapolation off the golden data by {max(errs):.2e} (bar {ERR_BAR})"
        raise SystemExit(msg)
    return {"max_abs_err": max(errs), "errs": errs}


if __name__ == "__main__":
    run(main, "macrostate_lnpi")

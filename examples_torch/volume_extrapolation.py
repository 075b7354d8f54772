"""Volume (density) extrapolation of the 1D ideal gas, on the port.

The PyTorch form of ``examples/volume_extrapolation.py``: first-order volume
expansion from virial data, general and ideal-gas-specialized modules, with
bootstrap uncertainty.  On the card the general model's order-1 moments of
the two value columns (x and its coordinate derivative) come from one pass
of K1 over u (V = 2), and the bootstrap from K6.

Run: python examples_torch/volume_extrapolation.py          (CUDA card, full size)
     python examples_torch/volume_extrapolation.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import numpy as np

from thermoextrap_tpu_torch import idealgas, volume, volume_idealgas


def main(smoke: bool = SMOKE) -> dict:
    beta, vol0 = 1.0, 1.0
    shape = (3_000, 50) if smoke else (100_000, 200)
    pos = idealgas.x_sample(shape, beta, vol0, rng=0)
    x = pos.mean(dim=-1)  # observable: mean position
    # virial = -sum_i q_i dU/dq_i = -U for the linear field; uv = beta*virial
    w = -beta * pos.sum(dim=-1)

    m_gen = volume.factory_extrapmodel(vol0, uv=w, xv=x, dxdqv=x, ndim=1)
    m_ig = volume_idealgas.factory_extrapmodel(vol0, uv=w, xv=x)
    boot = m_gen.resample({"nrep": 20 if smoke else 100})

    vols = np.array([0.7, 0.85, 1.0, 1.15, 1.3])
    print(f"{'vol':>6} {'general':>10} {'IG-variant':>11} {'+/-':>9} {'exact(o1)':>10}")
    zmax = 0.0
    for v in vols:
        pg = float(m_gen.predict(v))
        pi = float(m_ig.predict(v))
        err = float(boot.predict(v).std())
        exact = float(idealgas.x_vol_extrap(1, vol0, v, beta)[0])
        print(f"{v:6.2f} {pg:10.5f} {pi:11.5f} {err:9.1e} {exact:10.5f}")
        zmax = max(zmax, abs(pg - exact) / err)
    # the first-order expansion of the sampled <x> stays within a few
    # bootstrap sigma of the exact first-order expansion
    if not zmax < 6.0:
        msg = f"volume extrapolation {zmax:.1f} bootstrap sigma from the exact first-order answer"
        raise SystemExit(msg)
    return {"max_z_vs_exact": zmax}


if __name__ == "__main__":
    run(main, "volume_extrapolation")

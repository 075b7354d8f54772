"""Data organization: the container/constructor matrix, on the port.

The PyTorch form of ``examples/data_organization.py`` (the reference notebook
examples/usage/basic/Data_Organization.ipynb): how timeseries and
pre-computed moments map onto the data objects, and that every route into a
moment container agrees.

Layout convention (see ``thermoextrap_tpu_torch/data.py``): ``uv (*batch,
rec)``, ``xv (*batch, rec, [deriv+1,] *val)``; moment arrays keep the moment
order on the LEADING axis (``du[0]=1, du[1]=0``, ``dxdu[0]=0``).  The cmomy
trailing-moment-axes layout of ``from_data`` / ``cmom`` / ``rmom`` is the
migration seam.  On the card the value routes reduce with K1, the blocks
with K6, and the bootstrap goes through ``from_resample_vals``.

Run: python examples_torch/data_organization.py          (CUDA card, full size)
     python examples_torch/data_organization.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import torch

from thermoextrap_tpu_torch import idealgas
from thermoextrap_tpu_torch.compat import LabeledArray, from_labeled
from thermoextrap_tpu_torch.data import DataCentralMoments, DataValues


def _first(a) -> float:
    return float(a.reshape(-1)[0])


def main(smoke: bool = SMOKE) -> dict:
    order, beta0 = 4, 1.0
    shape = (1_000, 50) if smoke else (10_000, 200)
    x, u = idealgas.generate_data(shape, beta0, rng=0)

    # 1. value-backed container (keeps samples; resamplable)
    dv = DataValues.from_vals(x, u, order=order, central=True)

    # 2. moment-backed container from the same values (reduces immediately)
    dm = DataCentralMoments.from_vals(x, u, order=order)

    # 3. from pre-computed RAW moments  u[n] = <u^n>,  xu[n] = <x u^n>
    un = torch.stack([torch.mean(u**n) for n in range(order + 1)])
    xun = torch.stack([torch.mean(x * u**n) for n in range(order + 1)])
    d_raw = DataCentralMoments.from_raw(un, xun, central=True)

    # 4. from pre-computed CENTRAL moments
    du = torch.stack([torch.mean((u - u.mean()) ** n) for n in range(order + 1)])
    dxdu = torch.stack([torch.mean((x - x.mean()) * (u - u.mean()) ** n) for n in range(order + 1)])
    d_central = DataCentralMoments.from_ave_central(x.mean(), u.mean(), du, dxdu)

    # 5. migration seam: the cmomy trailing-moment-axes tensor round-trips
    d_cmom = DataCentralMoments.from_data(dm.cmom(), central=True)

    # every route feeds the SAME derivative-engine inputs
    rows = []
    for name, d in [
        ("values", dv),
        ("from_vals", dm),
        ("from_raw", d_raw),
        ("from_ave_central", d_central),
        ("from_data(cmom)", d_cmom),
    ]:
        xave, du_a, dxdu_a = (a.cpu() for a in d.derivs_args)
        row = (_first(xave), float(du_a.reshape(du_a.shape[0], -1)[2, 0]), float(dxdu_a.reshape(dxdu_a.shape[0], -1)[1, 0]))
        rows.append(row)
        print(f"{name:>18}: <x>={row[0]:.6f} <du^2>={row[1]:.6f} <dx du>={row[2]:.6f}")
    ref = rows[3]  # the float64 two-pass moments of step 4
    spread = [max(abs(r[i] - ref[i]) / abs(ref[i]) for r in rows) for i in range(3)]

    # 6. independent blocks: batched moments + exact pooled merge
    nblock = 4
    ub, xb = u.reshape(nblock, -1), x.reshape(nblock, -1)
    d_blocks = DataCentralMoments.from_vals(xb[..., None], ub, order=order)  # batch axis = block
    pooled = d_blocks.reduce(axis=0)
    pooled_x = _first(pooled.xave)
    print(
        f"{'block-reduce':>18}: <x>={pooled_x:.6f}  (== from_vals: "
        f"{abs(pooled_x - float(x.mean())) <= 1e-5 * abs(float(x.mean()))})"
    )

    # 7. streaming: accumulate chunks online, never retaining samples
    st = DataCentralMoments.zeros(order)
    for c in range(nblock):
        st = st.push_vals(xb[c], ub[c])
    print(f"{'streaming':>18}: <x>={float(st.xave):.6f}  (exact online pooling)")

    # 8. bootstrap straight into a replicated container
    d_boot = DataCentralMoments.from_resample_vals(x, u, order=order, sampler={"nrep": 10 if smoke else 50}, rng=0)
    boot_std = float(d_boot.xave.std())
    print(f"{'bootstrap':>18}: <x> std across replicates = {boot_std:.2e}")

    # 9. x_is_u: observable IS the energy (u-derivative chains) - pass xv=None
    d_u = DataCentralMoments.from_vals(None, u, order=order)
    print(f"{'x_is_u':>18}: <u>={float(d_u.uave):.6f}")

    # 10. migrating labeled (xarray-style) host arrays: axes are matched by dim
    # NAME, any order; works with real xarray.DataArrays or LabeledArray
    un_h, xn_h = u.cpu().numpy(), x.cpu().numpy()
    d_lab = from_labeled(
        LabeledArray(un_h, ("rec",)),
        LabeledArray(xn_h[:, None].T, ("val", "rec")),  # transposed on purpose
        order=order,
        central=True,
    )
    lab_x = _first(d_lab.xave)
    print(f"{'labeled dims':>18}: <x>={lab_x:.6f} (transposed (val, rec) input, fixed by name)")

    others = [pooled_x, float(st.xave), lab_x]
    spread[0] = max([spread[0]] + [abs(v - ref[0]) / abs(ref[0]) for v in others])
    # every route agrees with the float64 two-pass moments (the card's
    # reductions sum in float32)
    bars = (1e-5, 1e-4, 1e-4)
    if any(s > b for s, b in zip(spread, bars)):
        msg = f"routes disagree: relative spread of (<x>, <du^2>, <dx du>) {spread} over {bars}"
        raise SystemExit(msg)
    return {"route_spread_x": spread[0], "route_spread_du2": spread[1], "route_spread_dxdu1": spread[2], "boot_std": boot_std}


if __name__ == "__main__":
    run(main, "data_organization")

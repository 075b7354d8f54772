"""One state's count-table bootstrap,
``DataCentralMomentsVals.resample({"nrep": boot_nrep}, rng=...)``, run alone
on the first state's samples: its bound (``roofline_ops/table_boot.py``)
as a share of the device time of everything it launches (the index draw,
the count table, its scatter, and the bootstrap reduction's head shift,
kernel and finalize)."""

import torch

from portbench import roofline
from thermoextrap_tpu_torch import DataCentralMomentsVals


def read(ctx):
    e = ctx.entry
    if "boot_nrep" not in e:
        return None
    u, x2, order, nrep = e["u"], e["x2"], e["order"], e["boot_nrep"]
    data = DataCentralMomentsVals.from_vals(x2, u, order=order)
    gen = torch.Generator(device=u.device)

    def boot():
        gen.manual_seed(e["table_seed"])
        return data.resample({"nrep": nrep}, rng=gen)

    ms = ctx.device_ms(boot)
    if not ms:
        return None
    return roofline.share_pct("table_boot", ms, r=u.shape[0], v=x2.shape[1], order=order, nrep=nrep, itemsize=u.element_size())

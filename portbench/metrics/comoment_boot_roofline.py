"""The comoment Poisson bootstrap,
``ops.moments_cuda.resample_central_comoments_poisson``, run alone on the
operands one call hands it: its bound (``roofline_ops/comoment_boot.py``)
as a share of the device time of everything it launches."""

from portbench import roofline
from thermoextrap_tpu_torch.ops import moments_cuda


def read(ctx):
    e = ctx.entry
    if "x2" not in e or not e["nrep"]:
        return None
    u, x2, order, nrep = e["u"], e["x2"], e["order"], e["nrep"]
    ms = ctx.device_ms(lambda: moments_cuda.resample_central_comoments_poisson(u, x2, nrep, order, seed=1))
    if not ms:
        return None
    return roofline.share_pct(
        "comoment_boot", ms, r=u.shape[0], v=x2.shape[1], order=order, nrep=nrep, itemsize=u.element_size()
    )

"""The batched u-moment Poisson bootstrap,
``ops.moments_cuda.resample_central_umoments_batched_poisson``, run alone on
the grid one call hands it: its bound (``roofline_ops/umoment_boot.py``) as
a share of the device time of everything it launches."""

from portbench import roofline
from thermoextrap_tpu_torch.ops import moments_cuda


def read(ctx):
    e = ctx.entry
    if "uv" not in e or not e["nrep"]:
        return None
    uv, order, nrep = e["uv"], e["order"], e["nrep"]
    ms = ctx.device_ms(lambda: moments_cuda.resample_central_umoments_batched_poisson(uv, nrep, order, seed=1))
    if not ms:
        return None
    b, n = uv.shape
    return roofline.share_pct("umoment_boot", ms, b=b, n=n, order=order, nrep=nrep, itemsize=uv.element_size())

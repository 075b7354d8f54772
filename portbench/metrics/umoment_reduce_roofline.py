"""The batched u-moment reduction, ``ops.dispatch.reduce_central_u``, run
alone on the grid one call hands it: its bound (``roofline_ops/
umoment_reduce.py``) as a share of the device time of everything it
launches."""

from portbench import roofline
from thermoextrap_tpu_torch.ops import dispatch


def read(ctx):
    e = ctx.entry
    if "uv" not in e:
        return None
    uv, order = e["uv"], e["order"]
    ms = ctx.device_ms(lambda: dispatch.reduce_central_u(uv, order))
    if not ms:
        return None
    b, n = uv.shape
    return roofline.share_pct("umoment_reduce", ms, b=b, n=n, order=order, itemsize=uv.element_size())

"""The (u, x) comoment reduction, ``ops.dispatch.reduce_central``, run alone
on the operands one call hands it: its bound (``roofline_ops/
comoment_reduce.py``) as a share of the device time of everything it
launches."""

from portbench import roofline
from thermoextrap_tpu_torch.ops import dispatch


def read(ctx):
    e = ctx.entry
    if "x2" not in e:
        return None
    u, x2, order = e["u"], e["x2"], e["order"]
    ms = ctx.device_ms(lambda: dispatch.reduce_central(u, x2, order))
    if not ms:
        return None
    return roofline.share_pct(
        "comoment_reduce", ms, r=u.shape[0], v=x2.shape[1], order=order, itemsize=u.element_size()
    )

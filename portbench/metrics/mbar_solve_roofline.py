"""The MBAR solve, ``models.mbar.mbar_solve_info``, run alone on the
``u_kn`` one call builds: the bound of one iteration
(``roofline_ops/mbar_iter.py``) as a share of the device time per
iteration (the solve's device time over its iterations)."""

from portbench import roofline
from thermoextrap_tpu_torch.models import mbar


def read(ctx):
    e = ctx.entry
    if "u_kn" not in e:
        return None
    u_kn, n_k = e["u_kn"], e["n_k"]
    n_iter = mbar.mbar_solve_info(u_kn, n_k)[1]
    ms = ctx.device_ms(lambda: mbar.mbar_solve_info(u_kn, n_k))
    if not ms or not n_iter:
        return None
    k, n = u_kn.shape
    return roofline.share_pct("mbar_iter", ms / n_iter, k=k, n=n, itemsize=u_kn.element_size())

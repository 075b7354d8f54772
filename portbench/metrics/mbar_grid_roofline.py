"""MBAR's targets, ``models.mbar.mbar_expectations_alphas``, run alone on
the operands one call hands it, in the blocks of targets ``MBARModel``
takes (``models.extrap.mbar_alpha_chunk``): its bound
(``roofline_ops/mbar_grid.py``) as a share of the device time of everything
it launches.  None for a program without that block rule."""

from portbench import roofline
from thermoextrap_tpu_torch.models import extrap, mbar


def read(ctx):
    e = ctx.entry
    rule = getattr(extrap, "mbar_alpha_chunk", None)
    if "u_kn" not in e or rule is None:
        return None
    u_kn, n_k, u, x_n, alphas = e["u_kn"], e["n_k"], e["u_base"], e["x_n"], e["alphas"]
    f_k = mbar.mbar_solve(u_kn, n_k)
    chunk = rule(alphas.shape[0], u.shape[0])
    ms = ctx.device_ms(lambda: mbar.mbar_expectations_alphas(u_kn, n_k, f_k, alphas, u, x_n, chunk=chunk))
    if not ms:
        return None
    k, n = u_kn.shape
    a, v = alphas.shape[0], x_n.shape[1]
    return roofline.share_pct("mbar_grid", ms, k=k, n=n, a=a, v=v, itemsize=u_kn.element_size())

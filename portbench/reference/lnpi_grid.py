"""Plain float64 reference of the beta extrapolation of a macrostate
distribution lnPi(N) from each macrostate's energy samples, with the
bootstrap of its standard deviation (one count per replicate and sample,
shared by every macrostate).  It imports nothing of the program.

``predict`` reads the float32 grid ``uv (B, n)`` the benchmark made, ``ROWS``
macrostates at a time, and sums shifted powers of ``u`` in float64.
"""

from __future__ import annotations

import torch

from . import series

ROWS = 128


def predict(cfg: dict, inputs: dict, betas, *, counts=None) -> dict:
    """``{"pred" (A, B), "std" (A, B) or None, "c0" (B,)}`` at the targets
    ``betas``."""
    uv = inputs["uv"]
    order, beta0 = int(cfg["order"]), float(cfg["beta0"])
    lnpi0 = inputs["lnpi0"].double()
    mudotn = inputs["mudotn"].double()
    nbatch, n = uv.shape
    dbeta = torch.as_tensor(betas, dtype=torch.float64, device=uv.device) - beta0
    f = None if counts is None else counts.block(0, n).to(device=uv.device, dtype=torch.float64)
    preds, stds, c0 = [], [], []
    for b0 in range(0, nbatch, ROWS):
        u = uv[b0 : b0 + ROWS].double()
        s = u.mean(dim=1, keepdim=True)
        du = u - s
        p = torch.stack([du**k for k in range(order + 1)], dim=-1)  # (rows, n, order+1)
        sl = slice(b0, b0 + ROWS)
        coefs = _coefs(p.sum(1), s[:, 0], lnpi0[sl], mudotn[sl], order)  # (order+1, rows)
        preds.append(series.poly_eval(coefs, dbeta))
        c0.append(coefs[0])
        if f is not None:
            sums = torch.einsum("rj,bjk->rbk", f, p)  # (nrep, rows, order+1)
            bcoefs = _coefs(sums, s[None, :, 0], lnpi0[None, sl], mudotn[None, sl], order)
            stds.append(series.poly_eval(bcoefs, dbeta).std(dim=1, correction=0))
    return {
        "pred": torch.cat(preds, dim=1),
        "std": torch.cat(stds, dim=1) if stds else None,
        "c0": torch.cat(c0),
    }


def _coefs(sums_u, shift, lnpi0, mudotn, order: int):
    d, du, _, _ = series.central(sums_u, None, order)
    u_coefs = series.u_ave_coefs(shift + d, du, order - 1)
    return series.lnpi_coefs(u_coefs, lnpi0, mudotn, order)

"""Plain float64 reference of the beta extrapolation of <x> from (u, x)
samples, with the Poisson or multinomial bootstrap of its standard
deviation.  It imports nothing of the program.

``predict`` reads the float32 samples the benchmark made, in blocks of
``BLOCK`` samples, and sums shifted powers in float64: plain sums for the
point estimate, and for the bootstrap ``counts (nrep, n) @ powers (n,
order+1)`` per block on the counts the call's seed gives.
"""

from __future__ import annotations

import torch

from . import series

BLOCK = 1 << 20
_HEAD = 8192  # samples behind the shift


def _sums(u, x, su: float, sx: float, order: int, rows: int, counts):
    """Power sums ``(sums_u, sums_x)`` over the first ``rows`` samples: ``(order+1,)``
    each, or ``(nrep, order+1)`` with ``counts``."""
    acc_u = acc_x = 0.0
    spans = counts.spans(rows, BLOCK) if counts is not None else [(s, min(BLOCK, rows - s)) for s in range(0, rows, BLOCK)]
    for start, n in spans:
        du = u[start : start + n].double() - su
        dx = x[start : start + n].double() - sx
        p = torch.stack([du**k for k in range(order + 1)], dim=1)  # (n, order+1)
        px = p * dx[:, None]
        if counts is None:
            acc_u = acc_u + p.sum(0)
            acc_x = acc_x + px.sum(0)
        else:
            f = counts.block(start, n).to(device=u.device, dtype=torch.float64)
            acc_u = acc_u + f @ p
            acc_x = acc_x + f @ px
    return acc_u, acc_x


def coefs_from_sums(sums_u, sums_x, su: float, sx: float, order: int):
    _d, du, dx_off, dxdu = series.central(sums_u, sums_x, order)
    return series.x_ave_coefs(sx + dx_off, du, dxdu, order)


def predict(cfg: dict, inputs: dict, betas, *, counts=None, rows: int | None = None) -> dict:
    """``{"pred" (A,), "std" (A,) or None, "c0"}`` of the first ``rows``
    samples (all by default), at the targets ``betas``."""
    u, x = inputs["u"], inputs["x"]
    order, beta0 = int(cfg["order"]), float(cfg["beta0"])
    rows = u.shape[0] if rows is None else rows
    su = float(u[:_HEAD].double().mean())
    sx = float(x[:_HEAD].double().mean())
    dbeta = torch.as_tensor(betas, dtype=torch.float64, device=u.device) - beta0
    coefs = coefs_from_sums(*_sums(u, x, su, sx, order, rows, None), su, sx, order)
    out = {"pred": series.poly_eval(coefs, dbeta), "std": None, "c0": coefs[0]}
    if counts is not None:
        bcoefs = coefs_from_sums(*_sums(u, x, su, sx, order, rows, counts), su, sx, order)  # (order+1, nrep)
        out["std"] = series.poly_eval(bcoefs, dbeta).std(dim=1, correction=0)
    return out

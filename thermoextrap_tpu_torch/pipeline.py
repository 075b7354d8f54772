r"""Serving pipeline: samples → β-extrapolation of ⟨x⟩ (+ bootstrap CI).

Counterpart of ``make_extrap_pipeline`` in ``thermoextrap_tpu/pipeline.py``
(without a mesh; the streaming, lnΠ, volume, perturbation and GPR pipelines
are not ported yet).  The path runs by the device of the samples, decided
per call:

- CUDA: the shifted single-pass reduction kernel (K1), then, with
  ``nrep > 0``, the Poisson bootstrap kernel (K3) whose counts are drawn in
  the kernel, so no ``(nrep, R)`` table exists;
- CPU: the float64 two-pass reduction, then a multinomial count-table
  bootstrap drawn from a ``torch.Generator`` seeded with ``seed``.

The truncated-series coefficients and the Taylor evaluation always run in
float64 (a few hundred tiny operations), so the predictions are float64.
"""

from __future__ import annotations

import torch

from .data import _as_tensor
from .models.derivatives import central_u_ave_coefs, central_x_ave_coefs, central_x_ave_coefs_xalpha
from .models.extrap import _poly_eval
from .ops import dispatch, moments_cuda, resample
from .ops.series import series_neg_log
from .utils.random import validate_rng

__all__ = ["make_extrap_pipeline"]


def _xalpha_mean_coefs(xave, du, dxdu, order):
    """xalpha coefficients over the flat packed value width V = (order+1
    deriv columns) x (vv values): ``xave (V,)``, ``du (order+1, 1)``,
    ``dxdu (order+1, V)``."""
    vv = xave.shape[-1] // (order + 1)
    return central_x_ave_coefs_xalpha(
        xave.reshape(order + 1, vv), du, dxdu.reshape(order + 1, order + 1, vv), order
    )


def _xalpha_boot_coefs(bx, bdu, bdxdu, nrep, order):
    """Bootstrap variant: ``bx (nrep, V)``, ``bdu (order+1, nrep, 1)``,
    ``bdxdu (order+1, nrep, V)``; the deriv axis moves ahead of the
    replicate axis."""
    vv = bx.shape[-1] // (order + 1)
    x1 = torch.movedim(bx.reshape(nrep, order + 1, vv), 1, 0)
    dx = torch.movedim(bdxdu.reshape(order + 1, nrep, order + 1, vv), 2, 1)
    return central_x_ave_coefs_xalpha(x1, bdu, dx, order)


def _multinomial_freq(seed, nrep: int, nrec: int, device):
    gen = validate_rng(int(seed))
    return resample.freq_from_indices(resample.random_indices(gen, nrep, nrec, device=device), nrec)


def make_extrap_pipeline(
    order: int,
    beta0: float,
    *,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    nrep: int = 0,
    weighted: bool = False,
    bf16: bool = False,
):
    r"""Build ``run(uv, xv, betas, seed=0)`` for the β extrapolation of ⟨x⟩.

    ``order``: Taylor order.  ``beta0``: inverse temperature of the samples.
    ``minus_log``: predict ``-log <x>``.  ``xalpha``: ``xv (R, order+1,
    *val)`` carries the explicit β-derivatives of x.  ``x_is_u``: serve
    ⟨u⟩(β) from ``run(uv, betas, seed=0)``; CPU tensors only, since on
    CUDA it needs the kernels K4 / K5, which are not ported yet (raises
    ``NotImplementedError``).  ``nrep > 0``: also return the
    bootstrap standard deviation from ``nrep`` replicates.  ``weighted``:
    ``run`` takes a per-sample weight array after ``betas``.  ``bf16``:
    stream CUDA samples as bfloat16 (accumulation stays float32); CPU input
    ignores it.

    ``run`` returns ``pred (A, *val)`` or ``(pred, std)``, float64.
    """
    if x_is_u and xalpha:
        msg = "x_is_u and xalpha are mutually exclusive"
        raise ValueError(msg)

    def _post(c):
        return series_neg_log(c) if minus_log else c

    def _betas(betas, device):
        betas = torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float64, device=device))
        return betas, betas - beta0

    def _run(uv, xv, betas, weight, seed):
        uv = _as_tensor(uv)
        xv = _as_tensor(xv, uv.device)
        on_gpu = uv.device.type == "cuda"
        if bf16 and on_gpu:
            uv = uv.to(torch.bfloat16)
            xv = xv.to(torch.bfloat16)
        if xalpha:
            if xv.ndim < 2 or xv.shape[1] != order + 1:
                msg = (
                    f"xalpha xv needs a deriv axis of size order+1={order + 1} "
                    f"after the sample axis, got {tuple(xv.shape)}"
                )
                raise ValueError(msg)
            val_shape = tuple(xv.shape[2:])
        else:
            val_shape = tuple(xv.shape[1:])
        r = uv.shape[0]
        xflat = xv.reshape(r, -1)
        betas, dalpha = _betas(betas, uv.device)

        xave, _uave, du, dxdu = (
            t.double() for t in dispatch.reduce_central(uv, xflat, order, weight=weight)
        )
        if xalpha:
            coefs = _xalpha_mean_coefs(xave, du[:, None], dxdu, order)
        else:
            coefs = central_x_ave_coefs(xave, du[:, None], dxdu, order)
        pred = _poly_eval(_post(coefs), dalpha).reshape(betas.shape + val_shape)
        if not nrep:
            return pred

        if on_gpu:
            boot = moments_cuda.resample_central_comoments_poisson(
                uv, xflat, nrep, order, weight=weight, seed=seed
            )
        else:
            freq = _multinomial_freq(seed, nrep, r, uv.device)
            boot = resample.resample_central_comoments(uv, xflat, freq, order, weight=weight)
        bx, _bu, bdu, bdxdu = (t.double() for t in boot)
        if xalpha:
            bcoefs = _xalpha_boot_coefs(bx, bdu[:, :, None], bdxdu, nrep, order)
        else:
            bcoefs = central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, order)
        bpred = _poly_eval(_post(bcoefs), dalpha)
        std = bpred.std(dim=1, correction=0).reshape(betas.shape + val_shape)
        return pred, std

    def _run_u(uv, betas, weight, seed):
        uv = _as_tensor(uv)
        betas, dalpha = _betas(betas, uv.device)
        # on CUDA input this raises: x_is_u needs the unported K4 / K5
        uave, _u, du_m, dxdu_m = dispatch.reduce_central(
            uv, uv, order, weight=weight, val_ndim=0, x_is_u=True
        )
        du_full = torch.cat([du_m, dxdu_m[-1:]], dim=0).double()
        pred = _poly_eval(_post(central_u_ave_coefs(uave.double(), du_full, order)), dalpha)
        if not nrep:
            return pred
        freq = _multinomial_freq(seed, nrep, uv.shape[0], uv.device)
        bu, bdu_full = resample.resample_central_umoments_batched(uv[None], freq, order + 1, weight=weight)
        bcoefs = _post(central_u_ave_coefs(bu[:, 0].double(), bdu_full[..., 0].double(), order))
        return pred, _poly_eval(bcoefs, dalpha).std(dim=1, correction=0)

    if x_is_u:
        if weighted:

            def run(uv, betas, weight, seed=0):
                return _run_u(uv, betas, weight, seed)

        else:

            def run(uv, betas, seed=0):
                return _run_u(uv, betas, None, seed)

        return run

    if weighted:

        def run(uv, xv, betas, weight, seed=0):
            return _run(uv, xv, betas, weight, seed)

    else:

        def run(uv, xv, betas, seed=0):
            return _run(uv, xv, betas, None, seed)

    return run

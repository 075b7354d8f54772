r"""Serving pipelines: samples → extrapolation (+ bootstrap CI).

Counterpart of ``make_extrap_pipeline``, ``make_lnpi_pipeline`` and
``make_volume_pipeline`` in ``thermoextrap_tpu/pipeline.py`` (without a
mesh; the streaming, perturbation and GPR pipelines are not ported yet).
The path runs by the device of the samples, decided per call:

- CUDA: a shifted single-pass reduction kernel (K1 for ⟨x⟩ and volume, K4
  for ⟨u⟩ and the lnΠ grid), then, with ``nrep > 0``, a Poisson bootstrap
  kernel whose counts are drawn in the kernel (K3, or K5 for the u-moments),
  so no ``(nrep, R)`` table exists;
- CPU: the float64 two-pass reduction, then a multinomial count-table
  bootstrap drawn from a ``torch.Generator`` seeded with ``seed``.

The truncated-series coefficients and the Taylor evaluation always run in
float64 (a few hundred tiny operations), so the predictions are float64.
"""

from __future__ import annotations

import torch

from .data import _as_tensor
from .models.derivatives import central_u_ave_coefs, central_x_ave_coefs, central_x_ave_coefs_xalpha, lnpi_coefs
from .models.extrap import _poly_eval
from .ops import dispatch, moments_cuda, resample
from .ops.series import series_neg_log
from .utils.random import validate_rng

__all__ = ["make_extrap_pipeline", "make_lnpi_pipeline", "make_volume_pipeline"]


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
    ⟨u⟩(β) from ``run(uv, betas, seed=0)``, reading u alone (K4, then K5,
    on CUDA).  ``nrep > 0``: also return the
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
        on_gpu = uv.device.type == "cuda"
        if bf16 and on_gpu:
            uv = uv.to(torch.bfloat16)
        betas, dalpha = _betas(betas, uv.device)
        uave, _u, du_m, dxdu_m = dispatch.reduce_central(
            uv, uv, order, weight=weight, val_ndim=0, x_is_u=True
        )
        du_full = torch.cat([du_m, dxdu_m[-1:]], dim=0).double()
        pred = _poly_eval(_post(central_u_ave_coefs(uave.double(), du_full, order)), dalpha)
        if not nrep:
            return pred
        if on_gpu:
            bu, bdu_full = moments_cuda.resample_central_umoments_batched_poisson(
                uv[None], nrep, order + 1, weight=weight, seed=seed
            )
        else:
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


def make_lnpi_pipeline(order: int, beta0: float, *, nrep: int = 0):
    r"""Build ``run(uv, lnpi0, mudotn, betas, seed=0)`` for the β
    extrapolation of a macrostate distribution lnΠ over a grid.

    ``uv (*grid, R)`` holds each macrostate's energy samples, ``lnpi0
    (*grid,)`` the distribution at ``beta0`` and ``mudotn (*grid,)`` the
    per-macrostate ``μ·N``.  One reduction gives every macrostate's energy
    moments (K4 on CUDA, the float64 two-pass on CPU), and the series engine
    integrates ``(lnΠ)' = μ·N − ⟨u⟩`` term by term.  ``nrep > 0`` adds the
    bootstrap standard deviation: one count per (replicate, configuration),
    shared by the whole grid (K5 on CUDA, a multinomial table on CPU).

    ``run`` returns ``pred (A, *grid)`` or ``(pred, std)``, float64.
    """
    if order < 1:
        msg = f"lnPi order must be >= 1, got {order}"
        raise ValueError(msg)

    def _coefs(uave, du, lnpi0, mudotn):
        return lnpi_coefs(central_u_ave_coefs(uave, du, order - 1), lnpi0, mudotn, order)

    def run(uv, lnpi0, mudotn, betas, seed=0):
        uv = _as_tensor(uv)
        lnpi0 = _as_tensor(lnpi0, uv.device).double()
        mudotn = _as_tensor(mudotn, uv.device).double()
        betas = torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float64, device=uv.device))
        dalpha = betas - beta0

        uave, du = (t.double() for t in dispatch.reduce_central_u(uv, order))
        pred = _poly_eval(_coefs(uave, du, lnpi0, mudotn), dalpha)
        if not nrep:
            return pred
        if uv.device.type == "cuda":
            bu, bdu = moments_cuda.resample_central_umoments_batched_poisson(uv, nrep, order, seed=seed)
        else:
            freq = _multinomial_freq(seed, nrep, uv.shape[-1], uv.device)
            bu, bdu = resample.resample_central_umoments_batched(uv, freq, order)
        # the replicate axis rides as a leading batch axis of the coefficients
        bpred = _poly_eval(_coefs(bu.double(), bdu.double(), lnpi0[None], mudotn[None]), dalpha)
        return pred, bpred.std(dim=1, correction=0)

    return run


def make_volume_pipeline(
    volume0: float, *, ndim: int = 3, nrep: int = 0, weighted: bool = False, bf16: bool = False
):
    r"""Build ``run(wv, xv, dxdqv, volumes, seed=0)`` for the first-order
    volume extrapolation of ⟨x⟩,

    .. math:: d\langle x\rangle/dV = (\mathrm{cov}(x, W) + \langle dxdq\rangle) / (V_0 d),

    with ``wv (R,)`` the temperature-scaled virial ``β·virial``, ``xv (R,
    *val)`` the observable and ``dxdqv (R, *val)`` the samples of
    ``Σ_i ∂x/∂q_i q_i``.  ``x`` and ``dxdq`` ride as the value columns of ONE
    order-1 comoment reduction against ``W`` (K1 on CUDA), and ``nrep > 0``
    resamples whole configurations (K3 on CUDA, a multinomial table on CPU).
    ``weighted``: ``run`` takes a per-sample weight after ``volumes``.
    ``bf16``: stream CUDA samples as bfloat16.  ``run`` returns ``pred (A,
    *val)`` or ``(pred, std)``, float64.
    """
    order = 1  # higher orders would need force derivatives
    v0d = float(volume0) * float(ndim)

    def _run(wv, xv, dxdqv, volumes, weight, seed):
        wv = _as_tensor(wv)
        xv = _as_tensor(xv, wv.device)
        dxdqv = _as_tensor(dxdqv, wv.device)
        if xv.shape != dxdqv.shape:
            msg = f"xv {tuple(xv.shape)} and dxdqv {tuple(dxdqv.shape)} must match"
            raise ValueError(msg)
        on_gpu = wv.device.type == "cuda"
        if bf16 and on_gpu:
            wv, xv, dxdqv = (t.to(torch.bfloat16) for t in (wv, xv, dxdqv))
        val_shape = tuple(xv.shape[1:])
        r = wv.shape[0]
        xflat = xv.reshape(r, -1)
        v = xflat.shape[1]
        packed = torch.cat([xflat, dxdqv.reshape(r, -1)], dim=1)
        volumes = torch.atleast_1d(torch.as_tensor(volumes, dtype=torch.float64, device=wv.device))
        dalpha = volumes - volume0

        def _predict(xave, cov1, batch_ndim: int):
            # xave (*b, 2V): [x means | dxdq means]; cov1 (*b, V) = cov(x, W)
            deriv = (cov1 + xave[..., v:]) / v0d
            da = dalpha.reshape((-1,) + (1,) * (batch_ndim + 1))
            return xave[None, ..., :v] + da * deriv[None]

        xave, _uave, _du, dxdu = (t.double() for t in dispatch.reduce_central(wv, packed, order, weight=weight))
        pred = _predict(xave, dxdu[1, :v], 0).reshape(volumes.shape + val_shape)
        if not nrep:
            return pred
        if on_gpu:
            boot = moments_cuda.resample_central_comoments_poisson(wv, packed, nrep, order, weight=weight, seed=seed)
        else:
            freq = _multinomial_freq(seed, nrep, r, wv.device)
            boot = resample.resample_central_comoments(wv, packed, freq, order, weight=weight)
        bx, _bu, _bdu, bdxdu = (t.double() for t in boot)
        bpred = _predict(bx, bdxdu[1, :, :v], 1)
        return pred, bpred.std(dim=1, correction=0).reshape(volumes.shape + val_shape)

    if weighted:

        def run(wv, xv, dxdqv, volumes, weight, seed=0):
            return _run(wv, xv, dxdqv, volumes, weight, seed)

    else:

        def run(wv, xv, dxdqv, volumes, seed=0):
            return _run(wv, xv, dxdqv, volumes, None, seed)

    return run

r"""Serving pipelines: samples → extrapolation (+ bootstrap CI).

Counterpart of ``thermoextrap_tpu/pipeline.py``: the one-shot
``make_extrap_pipeline``, ``make_lnpi_pipeline``, ``make_volume_pipeline``
and ``make_perturb_pipeline``, their streaming forms
(``make_streaming_{extrap,lnpi,volume,perturb}_pipeline``), the streaming
interpolation between states (``make_streaming_interp_pipeline``),
``streaming_jackknife``, the bucketed serving runner
(``make_bucketed_extrap_runner``) and the GPR pipeline
(``make_gpr_pipeline``, float64 GP linear algebra on the GPR device).
Arrays that are not tensors go to the package's default
device (:func:`.utils.device.default_device`); the path then runs by the
device of the samples, decided per call:

- CUDA: a shifted single-pass reduction kernel (K1 for ⟨x⟩ and volume, K4
  for ⟨u⟩ and the lnΠ grid), then, with ``nrep > 0``, a Poisson bootstrap
  kernel whose counts are drawn in the kernel (K3, or K5 for the u-moments;
  K8 for the perturbation sums, or K7 against a count table), so no
  ``(nrep, R)`` table exists unless the caller asks for one;
- CPU: the float64 two-pass reduction, then a count-table bootstrap drawn
  from a ``torch.Generator`` seeded with ``seed``;
- a mesh (``mesh=``, a :class:`~torch.distributed.device_mesh.DeviceMesh`
  with a ``"rec"`` axis, see :mod:`.parallel`): the samples sharded over
  ``rec``, the reductions and the bootstrap of :mod:`.parallel.sharded`
  (plain torch, no kernel, ``bf16`` ignored), and for ``nrep > 0`` the
  count table the CPU route draws from ``seed``, drawn whole on the mesh's
  device and placed ``(rep, rec)``; so a ``mesh=`` call equals the
  unsharded CPU call at equal seed.  Inputs are whole arrays or
  ``DTensor``\ s placed by :func:`.parallel.shard_rec` (the lnΠ grid on its
  last axis); outputs are whole tensors, equal on every rank.

A streaming pipeline is ``(state0, update, predict)``: ``update`` reduces one
chunk by the same kernels and pools it exactly into the state (a
:class:`.data.DataCentralMoments`, or a tuple with the replicate accumulators
and the chunk counter), ``predict`` reads the state at any time.

The truncated-series coefficients and the Taylor evaluation always run in
float64 (a few hundred tiny operations), so the predictions are float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .data import DataCentralMoments, _as_tensor
from .models.derivatives import central_u_ave_coefs, central_x_ave_coefs, central_x_ave_coefs_xalpha, lnpi_coefs
from .models.extrap import _interp_eval, _interp_fit, _poly_eval, _weighted_sums
from .ops import dispatch, moments, moments_cuda, resample
from .ops.series import derivs_from_coefs, series_neg_log
from .parallel import sharded
from .utils.device import default_device, host_numpy, to_device
from .utils.random import validate_rng
from .utils.trace import call, span

__all__ = [
    "bucket_pad",
    "make_bucketed_extrap_runner",
    "make_extrap_pipeline",
    "make_gpr_pipeline",
    "make_lnpi_pipeline",
    "make_perturb_pipeline",
    "make_streaming_extrap_pipeline",
    "make_streaming_interp_pipeline",
    "make_streaming_lnpi_pipeline",
    "make_streaming_perturb_pipeline",
    "make_streaming_volume_pipeline",
    "make_volume_pipeline",
    "normalize_buckets",
    "streaming_jackknife",
]


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
    gen = validate_rng(int(seed), device=device)
    return resample.freq_from_indices(resample.random_indices(gen, nrep, nrec, device=device), nrec)


def _mesh_device(mesh, device=None):
    """The device of a pipeline with ``mesh`` (None: no mesh, ``device`` or
    the default device): the mesh's, which an explicit ``device`` must
    match."""
    if mesh is None:
        return default_device() if device is None else torch.device(device)
    if "rec" not in mesh.mesh_dim_names:
        msg = f"mesh= needs a 'rec' axis, got {mesh.mesh_dim_names}"
        raise ValueError(msg)
    dev = sharded._mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        msg = f"device={device} does not match the {mesh.device_type} mesh"
        raise ValueError(msg)
    return dev


def make_extrap_pipeline(
    order: int,
    beta0: float,
    *,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    nrep: int = 0,
    mesh=None,
    weighted: bool = False,
    bf16: bool = False,
):
    r"""Build ``run(uv, xv, betas, seed=0)`` for the β extrapolation of ⟨x⟩.

    ``order``: Taylor order.  ``beta0``: inverse temperature of the samples.
    ``minus_log``: predict ``-log <x>``.  ``xalpha``: ``xv (R, order+1,
    *val)`` carries the explicit β-derivatives of x.  ``x_is_u``: serve
    ⟨u⟩(β) from ``run(uv, betas, seed=0)``, reading u alone (K4, then K5,
    on CUDA).  ``nrep > 0``: also return the
    bootstrap standard deviation from ``nrep`` replicates.  ``mesh``: run
    sharded over a device mesh (see the module docstring).  ``weighted``:
    ``run`` takes a per-sample weight array after ``betas``.  ``bf16``:
    stream CUDA samples as bfloat16 (accumulation stays float32); CPU input
    and a mesh ignore it.

    ``run`` returns ``pred (A, *val)`` or ``(pred, std)``, float64.

    Examples
    --------
    >>> import numpy as np
    >>> run = make_extrap_pipeline(order=2, beta0=1.0)
    >>> uv = np.array([1.0, 2.0, 3.0, 4.0])
    >>> xv = np.array([[2.0], [4.0], [6.0], [8.0]])
    >>> pred = run(uv, xv, np.array([1.0]))  # at beta0: <x>
    >>> float(pred[0, 0])
    5.0
    """
    if x_is_u and xalpha:
        msg = "x_is_u and xalpha are mutually exclusive"
        raise ValueError(msg)
    mesh_device = None if mesh is None else _mesh_device(mesh)

    def _post(c):
        return series_neg_log(c) if minus_log else c

    def _betas(betas, device):
        betas = torch.atleast_1d(to_device(betas, device, torch.float64))
        return betas, betas - beta0

    def _run(uv, xv, betas, weight, seed):
        if mesh is None:
            uv = _as_tensor(uv)
            xv = _as_tensor(xv, uv.device)
        on_gpu = mesh is None and uv.device.type == "cuda"
        if bf16 and on_gpu:
            uv = uv.to(torch.bfloat16)
            xv = xv.to(torch.bfloat16)
        xshape = sharded._shape(xv)
        if xalpha:
            if len(xshape) < 2 or xshape[1] != order + 1:
                msg = (
                    f"xalpha xv needs a deriv axis of size order+1={order + 1} "
                    f"after the sample axis, got {xshape}"
                )
                raise ValueError(msg)
            val_shape = xshape[2:]
        else:
            val_shape = xshape[1:]
        r = xshape[0]
        betas, dalpha = _betas(betas, uv.device if mesh is None else mesh_device)

        if mesh is None:
            xflat = xv.reshape(r, -1)
            moments = dispatch.reduce_central(uv, xflat, order, weight=weight)
        else:
            moments = sharded.reduce_central_comoments_sharded(uv, xv, order, mesh, weight=weight)
        with span("te.coefs"):
            xave, _uave, du, dxdu = (t.double() for t in moments)
            xave, dxdu = xave.reshape(-1), dxdu.reshape(order + 1, -1)
            if xalpha:
                coefs = _xalpha_mean_coefs(xave, du[:, None], dxdu, order)
            else:
                coefs = central_x_ave_coefs(xave, du[:, None], dxdu, order)
            coefs = _post(coefs)
        with span("te.taylor"):
            pred = _poly_eval(coefs, dalpha).reshape(betas.shape + val_shape)
        if not nrep:
            return pred

        with span("te.boot"):
            if mesh is not None:
                freq = _multinomial_freq(seed, nrep, r, mesh_device)
                boot = sharded._full(*sharded.resample_central_comoments_sharded(uv, xv, freq, order, mesh, weight=weight))
            elif on_gpu:
                boot = moments_cuda.resample_central_comoments_poisson(
                    uv, xflat, nrep, order, weight=weight, seed=seed
                )
            else:
                freq = _multinomial_freq(seed, nrep, r, uv.device)
                boot = resample.resample_central_comoments(uv, xflat, freq, order, weight=weight)
        with span("te.coefs"):
            bx, _bu, bdu, bdxdu = (t.double() for t in boot)
            bx, bdxdu = bx.reshape(nrep, -1), bdxdu.reshape(order + 1, nrep, -1)
            if xalpha:
                bcoefs = _xalpha_boot_coefs(bx, bdu[:, :, None], bdxdu, nrep, order)
            else:
                bcoefs = central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, order)
            bcoefs = _post(bcoefs)
        with span("te.taylor"):
            bpred = _poly_eval(bcoefs, dalpha)
            std = bpred.std(dim=1, correction=0).reshape(betas.shape + val_shape)
        return pred, std

    def _run_u(uv, betas, weight, seed):
        if mesh is not None:
            return _run_u_mesh(uv, betas, weight, seed)
        uv = _as_tensor(uv)
        on_gpu = uv.device.type == "cuda"
        if bf16 and on_gpu:
            uv = uv.to(torch.bfloat16)
        betas, dalpha = _betas(betas, uv.device)
        uave, _u, du_m, dxdu_m = dispatch.reduce_central(
            uv, uv, order, weight=weight, val_ndim=0, x_is_u=True
        )
        with span("te.coefs"):
            du_full = torch.cat([du_m, dxdu_m[-1:]], dim=0).double()
            coefs = _post(central_u_ave_coefs(uave.double(), du_full, order))
        with span("te.taylor"):
            pred = _poly_eval(coefs, dalpha)
        if not nrep:
            return pred
        with span("te.boot"):
            if on_gpu:
                bu, bdu_full = moments_cuda.resample_central_umoments_batched_poisson(
                    uv[None], nrep, order + 1, weight=weight, seed=seed
                )
            else:
                freq = _multinomial_freq(seed, nrep, uv.shape[0], uv.device)
                bu, bdu_full = resample.resample_central_umoments_batched(uv[None], freq, order + 1, weight=weight)
        with span("te.coefs"):
            bcoefs = _post(central_u_ave_coefs(bu[:, 0].double(), bdu_full[..., 0].double(), order))
        with span("te.taylor"):
            return pred, _poly_eval(bcoefs, dalpha).std(dim=1, correction=0)

    def _run_u_mesh(uv, betas, weight, seed):
        # the one row of u as a batch of none: uave (), du (order+2,)
        betas, dalpha = _betas(betas, mesh_device)
        uave, du_full = sharded.reduce_central_umoments_batched_sharded(uv, order + 1, mesh, weight=weight)
        pred = _poly_eval(_post(central_u_ave_coefs(uave.double(), du_full.double(), order)), dalpha)
        if not nrep:
            return pred
        freq = _multinomial_freq(seed, nrep, sharded._shape(uv)[0], mesh_device)
        bu, bdu_full = sharded._full(*sharded.resample_central_umoments_batched_sharded(uv, freq, order + 1, mesh, weight=weight))
        bcoefs = _post(central_u_ave_coefs(bu.double(), bdu_full.double(), order))
        return pred, _poly_eval(bcoefs, dalpha).std(dim=1, correction=0)

    if x_is_u:
        if weighted:

            def run(uv, betas, weight, seed=0):
                with call("te.extrap"):
                    return _run_u(uv, betas, weight, seed)

        else:

            def run(uv, betas, seed=0):
                with call("te.extrap"):
                    return _run_u(uv, betas, None, seed)

        return run

    if weighted:

        def run(uv, xv, betas, weight, seed=0):
            with call("te.extrap"):
                return _run(uv, xv, betas, weight, seed)

    else:

        def run(uv, xv, betas, seed=0):
            with call("te.extrap"):
                return _run(uv, xv, betas, None, seed)

    return run


def make_lnpi_pipeline(order: int, beta0: float, *, nrep: int = 0, mesh=None):
    r"""Build ``run(uv, lnpi0, mudotn, betas, seed=0)`` for the β
    extrapolation of a macrostate distribution lnΠ over a grid.

    ``uv (*grid, R)`` holds each macrostate's energy samples, ``lnpi0
    (*grid,)`` the distribution at ``beta0`` and ``mudotn (*grid,)`` the
    per-macrostate ``μ·N``.  One reduction gives every macrostate's energy
    moments (K4 on CUDA, the float64 two-pass on CPU), and the series engine
    integrates ``(lnΠ)' = μ·N − ⟨u⟩`` term by term.  ``nrep > 0`` adds the
    bootstrap standard deviation: one count per (replicate, configuration),
    shared by the whole grid (K5 on CUDA, a multinomial table on CPU).
    ``mesh``: run sharded over a device mesh, ``uv``'s sample axis (its
    last) over ``rec`` (see the module docstring).

    ``run`` returns ``pred (A, *grid)`` or ``(pred, std)``, float64.
    """
    if order < 1:
        msg = f"lnPi order must be >= 1, got {order}"
        raise ValueError(msg)
    mesh_device = None if mesh is None else _mesh_device(mesh)

    def _coefs(uave, du, lnpi0, mudotn):
        with span("te.coefs"):
            return lnpi_coefs(central_u_ave_coefs(uave.double(), du.double(), order - 1), lnpi0, mudotn, order)

    def _run(uv, lnpi0, mudotn, betas, seed):
        if mesh is None:
            uv = _as_tensor(uv)
        device = uv.device if mesh is None else mesh_device
        lnpi0 = _as_tensor(lnpi0, device).double()
        mudotn = _as_tensor(mudotn, device).double()
        betas = torch.atleast_1d(to_device(betas, device, torch.float64))
        dalpha = betas - beta0

        if mesh is None:
            uave, du = dispatch.reduce_central_u(uv, order)
        else:
            uave, du = sharded.reduce_central_umoments_batched_sharded(uv, order, mesh)
        coefs = _coefs(uave, du, lnpi0, mudotn)
        with span("te.taylor"):
            pred = _poly_eval(coefs, dalpha)
        if not nrep:
            return pred
        with span("te.boot"):
            if mesh is not None:
                freq = _multinomial_freq(seed, nrep, sharded._shape(uv)[-1], device)
                bu, bdu = sharded._full(*sharded.resample_central_umoments_batched_sharded(uv, freq, order, mesh))
            elif uv.device.type == "cuda":
                bu, bdu = moments_cuda.resample_central_umoments_batched_poisson(uv, nrep, order, seed=seed)
            else:
                freq = _multinomial_freq(seed, nrep, uv.shape[-1], uv.device)
                bu, bdu = resample.resample_central_umoments_batched(uv, freq, order)
        # the replicate axis rides as a leading batch axis of the coefficients
        bcoefs = _coefs(bu, bdu, lnpi0[None], mudotn[None])
        with span("te.taylor"):
            return pred, _poly_eval(bcoefs, dalpha).std(dim=1, correction=0)

    def run(uv, lnpi0, mudotn, betas, seed=0):
        with call("te.lnpi"):
            return _run(uv, lnpi0, mudotn, betas, seed)

    return run


def make_volume_pipeline(
    volume0: float, *, ndim: int = 3, nrep: int = 0, mesh=None, weighted: bool = False, bf16: bool = False
):
    r"""Build ``run(wv, xv, dxdqv, volumes, seed=0)`` for the first-order
    volume extrapolation of ⟨x⟩,

    .. math:: d\langle x\rangle/dV = (\mathrm{cov}(x, W) + \langle dxdq\rangle) / (V_0 d),

    with ``wv (R,)`` the temperature-scaled virial ``β·virial``, ``xv (R,
    *val)`` the observable and ``dxdqv (R, *val)`` the samples of
    ``Σ_i ∂x/∂q_i q_i``.  ``x`` and ``dxdq`` ride as the value columns of ONE
    order-1 comoment reduction against ``W`` (K1 on CUDA), and ``nrep > 0``
    resamples whole configurations (K3 on CUDA, a multinomial table on CPU).
    ``mesh``: run sharded over a device mesh (see the module docstring).
    ``weighted``: ``run`` takes a per-sample weight after ``volumes``.
    ``bf16``: stream CUDA samples as bfloat16.  ``run`` returns ``pred (A,
    *val)`` or ``(pred, std)``, float64.

    Examples
    --------
    >>> import numpy as np
    >>> run = make_volume_pipeline(1.0, ndim=1)
    >>> wv = np.array([1.0, 2.0, 3.0, 4.0])
    >>> xv = 2.0 * wv
    >>> pred = run(wv, xv, np.zeros(4), np.array([1.0]))  # at V0: <x>
    >>> float(pred[0])
    5.0
    """
    order = 1  # higher orders would need force derivatives
    v0d = float(volume0) * float(ndim)
    mesh_device = None if mesh is None else _mesh_device(mesh)

    def _pack(x, d):
        n = x.shape[0]
        return torch.cat([x.reshape(n, -1), d.reshape(n, -1)], dim=1)

    def _run(wv, xv, dxdqv, volumes, weight, seed):
        if mesh is None:
            wv = _as_tensor(wv)
            xv = _as_tensor(xv, wv.device)
            dxdqv = _as_tensor(dxdqv, wv.device)
        xshape, dshape = sharded._shape(xv), sharded._shape(dxdqv)
        if xshape != dshape:
            msg = f"xv {xshape} and dxdqv {dshape} must match"
            raise ValueError(msg)
        on_gpu = mesh is None and wv.device.type == "cuda"
        if bf16 and on_gpu:
            wv, xv, dxdqv = (t.to(torch.bfloat16) for t in (wv, xv, dxdqv))
        val_shape = xshape[1:]
        r = xshape[0]
        v = math.prod(val_shape)
        device = wv.device if mesh is None else mesh_device
        packed = _pack(xv, dxdqv) if mesh is None else sharded._rec_map(_pack, [xv, dxdqv], mesh)
        volumes = torch.atleast_1d(to_device(volumes, device, torch.float64))
        dalpha = volumes - volume0

        def _predict(xave, cov1, batch_ndim: int):
            # xave (*b, 2V): [x means | dxdq means]; cov1 (*b, V) = cov(x, W)
            deriv = (cov1 + xave[..., v:]) / v0d
            da = dalpha.reshape((-1,) + (1,) * (batch_ndim + 1))
            return xave[None, ..., :v] + da * deriv[None]

        if mesh is None:
            moments = dispatch.reduce_central(wv, packed, order, weight=weight)
        else:
            moments = sharded.reduce_central_comoments_sharded(wv, packed, order, mesh, weight=weight)
        xave, _uave, _du, dxdu = (t.double() for t in moments)
        pred = _predict(xave, dxdu[1, :v], 0).reshape(volumes.shape + val_shape)
        if not nrep:
            return pred
        if mesh is not None:
            freq = _multinomial_freq(seed, nrep, r, device)
            boot = sharded._full(*sharded.resample_central_comoments_sharded(wv, packed, freq, order, mesh, weight=weight))
        elif on_gpu:
            boot = moments_cuda.resample_central_comoments_poisson(wv, packed, nrep, order, weight=weight, seed=seed)
        else:
            freq = _multinomial_freq(seed, nrep, r, device)
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


# ---------------------------------------------------------------------------
# perturbation reweighting
# ---------------------------------------------------------------------------


def _log_mask(weight, like):
    """``log w`` of per-sample weights with ``-inf`` where ``w <= 0``, so
    that zero-weight samples drop out exactly."""
    w = _as_tensor(weight, like.device).to(like.dtype)
    pos = w > 0
    return torch.where(pos, torch.log(torch.where(pos, w, torch.ones_like(w))), -torch.inf)


def _perturb_weights(uv, dalpha, weight, group=None):
    """Max-shift-stabilized unnormalized perturbation weights ``(A, R)``:
    ``exp(-dalpha_a u_n + log w_n - max_n)``.  Zero sample weights drop
    exactly (``-inf`` log mask), and a target whose samples are all masked
    gets a row of exact zeros (shift 0 in place of ``-inf``), so the 0/0 NaN
    of an empty target appears in one place, the normalization.  The
    ``(A, R)`` block is built in place: at ``A = 5``, ``R = 1e8`` each
    float32 temporary is 2 GB.  With a process group over which the samples
    are sharded, the maximum is the all-reduced one of every rank."""
    logw = -dalpha[:, None] * uv[None, :]
    if weight is not None:
        logw += _log_mask(weight, uv)[None, :]
    if uv.shape[0]:
        shift = logw.max(dim=1, keepdim=True).values
    else:
        shift = logw.new_full((logw.shape[0], 1), -torch.inf)
    if group is not None:
        torch.distributed.all_reduce(shift, op=torch.distributed.ReduceOp.MAX, group=group)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    return logw.sub_(shift).exp_()


def _perturb_predict(e, xflat, group=None):
    """``<x>`` per target from stabilized weights, ``(A, V)`` float64; the
    sums all-reduced over ``group`` when the samples are sharded."""
    sums = torch.cat([_weighted_sums(e, xflat), e.sum(dim=1)[:, None]], dim=1)
    if group is not None:
        torch.distributed.all_reduce(sums, group=group)
    sums = sums.double()
    return sums[:, :-1] / sums[:, -1:]


def _perturb_boot(e, xflat, freq):
    """Replicate predictions ``(A, nrep, V)``: the numerators of
    :func:`.ops.moments_cuda.resample_perturb_freq` over its weight sums."""
    v = xflat.shape[1]
    s = moments_cuda.resample_perturb_freq(e, xflat, freq)
    return s[..., :v] / s[..., v:]


def _count_table_dtype(like):
    """Type of a Poisson count table beside the samples ``like``: int8 on
    the card (K7 streams it as it is), the samples' own type on the CPU."""
    return torch.int8 if like.device.type == "cuda" else like.dtype


def make_perturb_pipeline(
    beta0: float, *, nrep: int = 0, mesh=None, weighted: bool = False, poisson: str = "device"
):
    r"""Build ``run(uv, xv, betas, seed=0)`` for exponential-reweighting
    perturbation, the zero-derivative serving path:

    .. math::

        \langle x\rangle_\beta = \frac{\langle x\, e^{-(\beta-\beta_0) u}
        \rangle_{\beta_0}}{\langle e^{-(\beta-\beta_0) u}\rangle_{\beta_0}}

    stabilized by a max shift and evaluated for every target β at once.
    ``nrep > 0`` also returns the bootstrap standard deviation: Poisson(1)
    counts pushed through the same stabilized weights.  On CUDA
    ``poisson="device"`` draws the counts inside the kernel (K8; no table
    exists) and ``poisson="table"`` draws one int8
    :func:`.ops.resample.poisson1_freq` table from the call's seed (K7), so
    that the counts are those of the plain path at equal seed; any number of
    targets runs in the kernel.  On CPU both modes run the table through the
    plain einsum in the samples' type.  ``mesh``: the samples sharded over
    ``rec``; the shift is the all-reduced maximum, the prediction's sums and
    the bootstrap's (the CPU route's count table from ``seed``, through the
    plain einsum, in either mode) are all-reduced (see the module
    docstring).  ``weighted``: ``run`` takes a
    per-sample weight after ``betas`` (zero weights drop samples exactly).

    ``run`` maps ``uv (R,)``, ``xv (R, *val)``, ``betas (A,)`` to ``pred (A,
    *val)`` or ``(pred, std)``, float64.  A target or replicate of zero
    total weight gives NaN (0/0 at the normalization).

    Examples
    --------
    >>> import numpy as np
    >>> run = make_perturb_pipeline(1.0)
    >>> uv = np.array([0.5, 1.0, 1.5, 2.0])
    >>> pred = run(uv, 3.0 * uv, np.array([1.0]))  # at beta0: plain mean
    >>> np.testing.assert_allclose(pred[0].item(), np.mean(3.0 * uv))
    """
    if poisson not in ("table", "device"):
        msg = f"poisson must be 'table' or 'device', got {poisson!r}"
        raise ValueError(msg)
    mesh_device = None if mesh is None else _mesh_device(mesh)

    def _run_mesh(uv, xv, betas, weight, seed):
        group = mesh.get_group("rec")
        r = sharded._shape(uv)[0]
        val_shape = sharded._shape(xv)[1:]
        u_l = sharded._local(uv, mesh, {"rec": 0})
        x_l = sharded._local(xv, mesh, {"rec": 0})
        x_l = x_l.reshape(x_l.shape[0], -1)
        w_l = None if weight is None else sharded._weight_local(weight, uv, u_l, mesh, {"rec": 0})
        betas = torch.atleast_1d(to_device(betas, mesh_device, torch.float64))
        e = _perturb_weights(u_l, (betas - beta0).to(u_l.dtype), w_l, group)
        pred = _perturb_predict(e, x_l, group).reshape(betas.shape + val_shape)
        if not nrep:
            return pred
        gen = validate_rng(int(seed), device=mesh_device)
        freq = resample.poisson1_freq(gen, (nrep, r), dtype=u_l.dtype)
        s = moments_cuda.resample_perturb_plain(e, x_l, sharded._local(freq, mesh, {"rec": 1}))
        torch.distributed.all_reduce(s, group=group)
        s = s.double()
        v = x_l.shape[1]
        bpred = s[..., :v] / s[..., v:]
        return pred, bpred.std(dim=1, correction=0).reshape(betas.shape + val_shape)

    def _run(uv, xv, betas, weight, seed):
        if mesh is not None:
            return _run_mesh(uv, xv, betas, weight, seed)
        uv = _as_tensor(uv)
        xv = _as_tensor(xv, uv.device)
        betas = torch.atleast_1d(to_device(betas, uv.device, torch.float64))
        val_shape = tuple(xv.shape[1:])
        r = uv.shape[0]
        xflat = xv.reshape(r, -1)
        v = xflat.shape[1]
        e = _perturb_weights(uv, (betas - beta0).to(uv.dtype), weight)
        pred = _perturb_predict(e, xflat).reshape(betas.shape + val_shape)
        if not nrep:
            return pred
        # the kernels stream the stabilized rows the prediction used
        if uv.device.type == "cuda" and poisson == "device":
            s = moments_cuda.resample_perturb_poisson(e, xflat, nrep, seed=seed)
        else:
            gen = validate_rng(int(seed), device=uv.device)
            freq = resample.poisson1_freq(gen, (nrep, r), dtype=_count_table_dtype(uv))
            s = moments_cuda.resample_perturb_freq(e, xflat, freq)
        s = s.double()
        bpred = s[..., :v] / s[..., v:]
        return pred, bpred.std(dim=1, correction=0).reshape(betas.shape + val_shape)

    if weighted:

        def run(uv, xv, betas, weight, seed=0):
            return _run(uv, xv, betas, weight, seed)

    else:

        def run(uv, xv, betas, seed=0):
            return _run(uv, xv, betas, None, seed)

    return run


# ---------------------------------------------------------------------------
# streaming pipelines
# ---------------------------------------------------------------------------


def _chunk_seed(seed: int, step: int) -> int:
    """The 64-bit seed of chunk ``step``: a Weyl step of the odd golden-ratio
    constant, so that for one base seed no two chunks share a stream."""
    return (int(seed) + int(step) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF


def _chunk_freq(seed: int, step: int, nrep: int, nrec: int, device):
    """The CPU path's Poisson(1) count table of one chunk, ``(nrep, nrec)``
    int32, from a generator keyed on ``(seed, chunk index)``."""
    gen = validate_rng(_chunk_seed(seed, step), device=device)
    return resample.poisson1_freq(gen, (nrep, nrec), dtype=torch.int32)


def _step0(device, xla: bool):
    """A fresh chunk counter: a 0-d int64 tensor on the ``xla_only`` route
    (a traced update carries it as an operand), else the Python int 0."""
    return torch.zeros((), dtype=torch.int64, device=device) if xla else 0


def _chunk_counts(seed: int, nrep: int, device, xla: bool):
    """``counts(step, nrec)``: the count table ``(nrep, nrec)`` of chunk
    ``step`` of a streaming bootstrap off the kernel route.  On the
    ``xla_only`` route the counts K3, K5 and K8 draw at the chunk's seed
    (:func:`.ops.resample.philox_poisson1_counts`, ``step`` a 0-d int64
    tensor); otherwise the CPU route's generator table (:func:`_chunk_freq`)."""
    if not xla:
        return lambda step, nrec: _chunk_freq(seed, step, nrep, nrec, device)
    base = resample.seed_tensor(seed, device)
    return lambda step, nrec: resample.philox_poisson1_counts(resample.chunk_seed(base, step), nrep, nrec)


def _as_f64(device, *arrays):
    """The ``xla_only`` route's operands: on ``device``, in float64 (the
    plain sums of a float32 chunk run in float64); None passes through."""
    return tuple(None if a is None else _as_tensor(a, device).to(torch.float64) for a in arrays)


def _freq_wsum(freq, weight, dtype):
    """Per-replicate total weight ``sum_j freq[r, j] w_j``."""
    fw = freq.to(dtype)
    if weight is not None:
        fw = fw * weight.to(dtype)[None, :]
    return fw.sum(dim=1)


def _split_state(state, nrep: int):
    """``(mean, rep, step)`` of a streaming state (``rep`` and ``step`` are
    None without replicates)."""
    return state if nrep else (state, None, None)


def make_streaming_extrap_pipeline(
    order: int,
    beta0: float,
    *,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    val_shape: tuple[int, ...] = (),
    dtype=torch.float64,
    bf16: bool = False,
    nrep: int = 0,
    seed: int = 0,
    device=None,
    mesh=None,
    xla_only: bool = False,
):
    r"""Streaming form of :func:`make_extrap_pipeline`: fold sample chunks
    into a running moment state as a simulation runs and predict at any time,
    keeping no samples.

    Each ``update`` reduces one chunk (K1 on CUDA, K4 with ``x_is_u``) and
    pools it exactly into the state
    (:meth:`.data.DataCentralMoments.push_vals`), so the state after any
    chunking is the one-shot state up to floating-point associativity.

    ``order``, ``beta0``, ``minus_log``, ``xalpha``, ``x_is_u``: as in
    :func:`make_extrap_pipeline`; with ``xalpha`` a chunk's ``xv`` is
    ``(chunk, order+1, *val_shape)``, with ``x_is_u`` ``update`` takes no
    ``xv`` and ``val_shape`` must be ``()``.  ``dtype``: type of the carried
    state (every update casts its chunk's moments to it, so structure and
    type never change); float64 by default, the type the kernels' partial
    sums and the series are already evaluated in.  ``bf16``: stream CUDA chunks as bfloat16.
    ``nrep > 0``: the state also carries ``nrep`` Poisson-bootstrap replicate
    accumulators and a chunk counter, and ``predict`` returns ``(pred,
    std)``.  Each chunk is folded into every replicate with its own
    Poisson(1) counts, which is one Poisson bootstrap of the whole stream;
    on CUDA the counts are drawn in the kernel (K3, or K5 with ``x_is_u``)
    from ``(seed, chunk index)``, on CPU from a count table of a generator
    keyed the same way.  ``device``: where the state lives and chunks are
    sent (the default device when None).  ``mesh``: each chunk sharded over
    ``rec`` (a whole array or a ``DTensor`` of :func:`.parallel.shard_rec`),
    reduced by :mod:`.parallel.sharded` and merged into a state on the
    mesh's device; the replicates fold the CPU route's per-chunk count
    tables; ``bf16`` is ignored.  ``xla_only``: the plain route on every
    device, the counterpart of the JAX package's pure-XLA seam that
    :mod:`.serving_export` traces: each chunk is reduced in float64 by the
    plain two-pass functions, ``bf16`` is ignored, and the replicates fold
    the counts of :func:`.ops.resample.philox_poisson1_counts` keyed on
    ``(seed, chunk index)``, the counts K3 and K5 draw at that seed; the
    chunk counter is then a 0-d int64 tensor, so no Python branch reads a
    tensor value or the chunk length and the update traces with a symbolic
    chunk length.  Ignored with ``mesh``.

    Returns ``(state0, update, predict)``: ``update(state, uv, xv,
    weight=None) -> state`` (``update(state, uv, weight=None)`` with
    ``x_is_u``) and ``predict(state, betas) -> (A, *val_shape)`` float64, or
    ``(pred, std)``.

    Examples
    --------
    >>> import numpy as np
    >>> state, update, predict = make_streaming_extrap_pipeline(2, 1.0)
    >>> state = update(state, np.array([1.0, 2.0]), np.array([2.0, 4.0]))
    >>> state = update(state, np.array([3.0, 4.0]), np.array([6.0, 8.0]))
    >>> float(predict(state, np.array([1.0]))[0])  # <x> at beta0
    5.0
    """
    if x_is_u and xalpha:
        msg = "x_is_u and xalpha are mutually exclusive"
        raise ValueError(msg)
    if x_is_u and tuple(val_shape):
        msg = "x_is_u streams scalar energies; val_shape must be ()"
        raise ValueError(msg)
    device = _mesh_device(mesh, device)
    xla = xla_only and mesh is None
    on_gpu = mesh is None and device.type == "cuda" and not xla
    # with xalpha the derivative columns ride as a leading value axis of the
    # accumulator and are disentangled only at predict time
    val_shape = (order + 1, *val_shape) if xalpha else tuple(val_shape)
    pad = (1,) * len(val_shape)
    counts = _chunk_counts(seed, nrep, device, xla)

    def zeros(batch_shape):
        return DataCentralMoments.zeros(
            order, batch_shape=batch_shape, val_shape=val_shape, dtype=dtype, device=device, x_is_u=x_is_u
        )

    state0 = (zeros(()), zeros((nrep,)), _step0(device, xla)) if nrep else zeros(())

    def _rep_update_u(rep, step, uv, weight):
        # batched u-moment bootstrap of one row at order + 1, whose extra
        # moment gives the comoments by the shift view dxdu[n] = du[n+1]
        with span("te.boot"):
            if on_gpu:
                bu, bdu_full, bwsum = moments_cuda.resample_central_umoments_batched_poisson(
                    uv[None], nrep, order + 1, weight=weight, seed=_chunk_seed(seed, step), return_wsum=True
                )
                bwsum = bwsum[:, 0]
            else:
                freq = counts(step, uv.shape[0])
                bu, bdu_full = resample.resample_central_umoments_batched(uv[None], freq, order + 1, weight=weight)
                bwsum = _freq_wsum(freq, weight, rep.wsum.dtype)
        chunk_rep = dataclasses.replace(
            rep,
            xave=bu[:, 0],
            uave=bu[:, 0],
            du=bdu_full[: order + 1, :, 0],
            dxdu=bdu_full[1 : order + 2, :, 0],
            wsum=bwsum,
        )
        return rep.merge(chunk_rep)

    def _rep_update(rep, step, uv, xflat, weight):
        with span("te.boot"):
            if on_gpu:
                bx, bu, bdu, bdxdu, bwsum = moments_cuda.resample_central_comoments_poisson(
                    uv, xflat, nrep, order, weight=weight, seed=_chunk_seed(seed, step), return_wsum=True
                )
            else:
                freq = counts(step, uv.shape[0])
                bx, bu, bdu, bdxdu = resample.resample_central_comoments(uv, xflat, freq, order, weight=weight)
                bwsum = _freq_wsum(freq, weight, rep.wsum.dtype)
        chunk_rep = dataclasses.replace(
            rep,
            xave=bx.reshape(nrep, *val_shape),
            uave=bu,
            du=bdu.reshape((order + 1, nrep, *pad)),
            dxdu=bdxdu.reshape((order + 1, nrep, *val_shape)),
            wsum=bwsum,
        )
        # a replicate that drew no sample of this chunk has zero weight; the
        # merge masks zero-weight members
        return rep.merge(chunk_rep)

    def _mesh_mean(mean, uv, xv, weight):
        if x_is_u:
            uave, du_full, wsum = sharded.reduce_central_umoments_batched_sharded(
                uv, order + 1, mesh, weight=weight, return_wsum=True
            )
            chunk = dataclasses.replace(
                mean, xave=uave, uave=uave, du=du_full[: order + 1], dxdu=du_full[1 : order + 2], wsum=wsum
            )
        else:
            xave, uave, du, dxdu, wsum = sharded.reduce_central_comoments_sharded(
                uv, xv, order, mesh, weight=weight, return_wsum=True
            )
            chunk = dataclasses.replace(
                mean, xave=xave, uave=uave, du=du.reshape((order + 1, *pad)), dxdu=dxdu, wsum=wsum
            )
        return mean.merge(chunk)

    def _mesh_rep(rep, step, uv, xv, weight):
        with span("te.boot"):
            freq = _chunk_freq(seed, step, nrep, sharded._shape(uv)[0], device)
            if x_is_u:
                bu, bdu_full, bwsum = sharded._full(
                    *sharded.resample_central_umoments_batched_sharded(uv, freq, order + 1, mesh, weight=weight, return_wsum=True)
                )
                chunk = dataclasses.replace(
                    rep, xave=bu, uave=bu, du=bdu_full[: order + 1], dxdu=bdu_full[1 : order + 2], wsum=bwsum
                )
            else:
                bx, bu, bdu, bdxdu, bwsum = sharded._full(
                    *sharded.resample_central_comoments_sharded(uv, xv, freq, order, mesh, weight=weight, return_wsum=True)
                )
                chunk = dataclasses.replace(
                    rep, xave=bx, uave=bu, du=bdu.reshape((order + 1, nrep, *pad)), dxdu=bdxdu, wsum=bwsum
                )
        return rep.merge(chunk)

    def _update_mesh(state, uv, xv, weight):
        if not x_is_u:
            xv = sharded._rec_map(lambda x: x.reshape(x.shape[0], *val_shape), [xv], mesh)
        mean_s, rep_s, step = _split_state(state, nrep)
        mean_s = _mesh_mean(mean_s, uv, xv, weight)
        if not nrep:
            return mean_s
        return mean_s, _mesh_rep(rep_s, step, uv, xv, weight), step + 1

    def _update(state, uv, xv, weight):
        if mesh is not None:
            return _update_mesh(state, uv, xv, weight)
        if xla:
            with dispatch.use_impl("torch"):
                return _update_local(state, *_as_f64(device, uv, xv, weight))
        return _update_local(state, uv, xv, weight)

    def _update_local(state, uv, xv, weight):
        uv = _as_tensor(uv, device)
        weight = None if weight is None else _as_tensor(weight, device)
        if not x_is_u:
            xv = _as_tensor(xv, device).reshape(uv.shape[0], *val_shape)
        if bf16 and on_gpu:
            uv = uv.to(torch.bfloat16)
            xv = None if x_is_u else xv.to(torch.bfloat16)
        mean_s, rep_s, step = _split_state(state, nrep)
        mean_s = mean_s.push_vals(xv, uv, weight=weight)
        if not nrep:
            return mean_s
        if x_is_u:
            rep_s = _rep_update_u(rep_s, step, uv, weight)
        else:
            rep_s = _rep_update(rep_s, step, uv, xv.flatten(1) if xv.ndim > 1 else xv[:, None], weight)
        return mean_s, rep_s, step + 1

    if x_is_u:

        def update(state, uv, weight=None):
            with call("te.stream.update"):
                return _update(state, uv, None, weight)

    else:

        def update(state, uv, xv, weight=None):
            with call("te.stream.update"):
                return _update(state, uv, xv, weight)

    def _coefs(s, *, rep: bool = False):
        with span("te.coefs"):
            xave, du, dxdu = s.xave.double(), s.du.double(), s.dxdu.double()
            if xalpha:
                # the xalpha recursion wants the deriv axis at position 0 (x1) /
                # 1 (dxdu); in the accumulator it sits after the replicate axis,
                # and du carries its broadcast pad
                if rep:
                    c = central_x_ave_coefs_xalpha(
                        torch.movedim(xave, 1, 0), du.squeeze(2), torch.movedim(dxdu, 2, 1), order
                    )
                else:
                    c = central_x_ave_coefs_xalpha(xave, du.squeeze(1), dxdu, order)
            else:
                c = central_x_ave_coefs(xave, du, dxdu, order)
            return series_neg_log(c) if minus_log else c

    def _predict(state, betas):
        mean_s, rep_s, _step = _split_state(state, nrep)
        betas = torch.atleast_1d(to_device(betas, device, torch.float64))
        dalpha = betas - beta0
        coefs = _coefs(mean_s)
        with span("te.taylor"):
            pred = _poly_eval(coefs, dalpha)
        if not nrep:
            return pred
        bcoefs = _coefs(rep_s, rep=True)
        with span("te.taylor"):
            return pred, _poly_eval(bcoefs, dalpha).std(dim=1, correction=0)

    def predict(state, betas):
        with call("te.stream.predict"):
            return _predict(state, betas)

    return state0, update, predict


def make_streaming_lnpi_pipeline(
    order: int,
    beta0: float,
    *,
    grid_shape: tuple[int, ...],
    dtype=torch.float64,
    nrep: int = 0,
    seed: int = 0,
    device=None,
    mesh=None,
    xla_only: bool = False,
):
    r"""Streaming form of :func:`make_lnpi_pipeline`: fold
    ``(*grid_shape, chunk)`` blocks of macrostate energy samples into a
    batched ``x_is_u`` moment state (K4 on CUDA) and predict lnΠ at any time.

    ``nrep > 0`` adds ``nrep`` replicate grid accumulators whose counts are
    shared across the grid (a replicate resamples whole configurations): K5
    on CUDA with a seed per chunk, a count table per chunk on CPU.
    ``dtype``, ``seed``, ``device``, ``mesh``, ``xla_only``: as in
    :func:`make_streaming_extrap_pipeline` (each block's sample axis, its
    last, sharded over ``rec``; on the ``xla_only`` route the counts are
    those K5 draws).

    Returns ``(state0, update, predict)``: ``update(state, uv) -> state`` and
    ``predict(state, lnpi0, mudotn, betas) -> (A, *grid_shape)`` float64, or
    ``(pred, std)``.
    """
    if order < 1:
        msg = f"lnPi order must be >= 1, got {order}"
        raise ValueError(msg)
    device = _mesh_device(mesh, device)
    xla = xla_only and mesh is None
    on_gpu = mesh is None and device.type == "cuda" and not xla
    grid_shape = tuple(grid_shape)
    counts = _chunk_counts(seed, nrep, device, xla)

    def zeros(batch_shape):
        return DataCentralMoments.zeros(order, batch_shape=batch_shape, x_is_u=True, dtype=dtype, device=device)

    state0 = (zeros(grid_shape), zeros((nrep, *grid_shape)), _step0(device, xla)) if nrep else zeros(grid_shape)

    def _mean_update(mean, uv):
        if mesh is None and not xla:
            return mean.push_vals(None, uv)
        if mesh is None:
            # the u-moments at order + 1 give the comoments by the shift view
            uave, du_full = moments.reduce_central_umoments(uv, order + 1)
            wsum = torch.ones_like(uv).sum(dim=-1)
        else:
            uave, du_full, wsum = sharded.reduce_central_umoments_batched_sharded(uv, order + 1, mesh, return_wsum=True)
        return mean.merge(
            dataclasses.replace(mean, xave=uave, uave=uave, du=du_full[: order + 1], dxdu=du_full[1 : order + 2], wsum=wsum)
        )

    def _rep_update(rep, step, uv):
        if on_gpu:
            bu, bdu_full, bwsum = moments_cuda.resample_central_umoments_batched_poisson(
                uv, nrep, order + 1, seed=_chunk_seed(seed, step), return_wsum=True
            )
        else:
            freq = counts(step, sharded._shape(uv)[-1])
            if mesh is None:
                bu, bdu_full = resample.resample_central_umoments_batched(uv, freq, order + 1)
            else:
                bu, bdu_full = sharded._full(*sharded.resample_central_umoments_batched_sharded(uv, freq, order + 1, mesh))
            bwsum = _freq_wsum(freq, None, rep.wsum.dtype).reshape((nrep,) + (1,) * len(grid_shape))
            bwsum = bwsum.expand(nrep, *grid_shape)
        chunk_rep = dataclasses.replace(
            rep, xave=bu, uave=bu, du=bdu_full[: order + 1], dxdu=bdu_full[1 : order + 2], wsum=bwsum
        )
        return rep.merge(chunk_rep)

    def _update(state, uv):
        mean_s, rep_s, step = _split_state(state, nrep)
        mean_s = _mean_update(mean_s, uv)
        if not nrep:
            return mean_s
        return mean_s, _rep_update(rep_s, step, uv), step + 1

    def update(state, uv):
        if xla:
            with dispatch.use_impl("torch"):
                return _update(state, *_as_f64(device, uv))
        if mesh is None:
            uv = _as_tensor(uv, device)
        return _update(state, uv)

    def _coefs(s, batch, lnpi0, mudotn):
        du = s.du.double().reshape((order + 1, *batch))
        return lnpi_coefs(central_u_ave_coefs(s.uave.double(), du, order - 1), lnpi0, mudotn, order)

    def predict(state, lnpi0, mudotn, betas):
        mean_s, rep_s, _step = _split_state(state, nrep)
        lnpi0 = _as_tensor(lnpi0, device).double()
        mudotn = _as_tensor(mudotn, device).double()
        betas = torch.atleast_1d(to_device(betas, device, torch.float64))
        dalpha = betas - beta0
        pred = _poly_eval(_coefs(mean_s, grid_shape, lnpi0, mudotn), dalpha)
        if not nrep:
            return pred
        bpred = _poly_eval(_coefs(rep_s, (nrep, *grid_shape), lnpi0[None], mudotn[None]), dalpha)
        return pred, bpred.std(dim=1, correction=0)

    return state0, update, predict


def make_streaming_volume_pipeline(
    volume0: float,
    *,
    ndim: int = 3,
    val_shape: tuple[int, ...] = (),
    dtype=torch.float64,
    bf16: bool = False,
    nrep: int = 0,
    seed: int = 0,
    device=None,
    mesh=None,
    xla_only: bool = False,
):
    r"""Streaming form of :func:`make_volume_pipeline`: the order-1 streaming
    comoment accumulator of :func:`make_streaming_extrap_pipeline` with ``x``
    and ``dxdq`` packed as a leading value axis (``cov(x, W)`` is the order-1
    comoment of the first packed column, ``<dxdq>`` the mean of the second),
    plus the volume prediction.  ``mesh``, ``xla_only``: as in
    :func:`make_streaming_extrap_pipeline`.

    Returns ``(state0, update, predict)``: ``update(state, wv, xv, dxdqv,
    weight=None) -> state`` (``wv (chunk,)`` the temperature-scaled virial,
    ``xv`` / ``dxdqv (chunk, *val_shape)``) and ``predict(state, volumes) ->
    (A, *val_shape)`` float64, or ``(pred, std)`` when ``nrep > 0``.

    Examples
    --------
    >>> import numpy as np
    >>> state, update, predict = make_streaming_volume_pipeline(1.0, ndim=1)
    >>> wv = np.array([1.0, 2.0, 3.0, 4.0])
    >>> state = update(state, wv[:2], 2.0 * wv[:2], np.zeros(2))
    >>> state = update(state, wv[2:], 2.0 * wv[2:], np.zeros(2))
    >>> float(predict(state, np.array([1.0]))[0])  # <x> at V0
    5.0
    """
    val_shape = tuple(val_shape)
    v0d = float(volume0) * float(ndim)
    device = _mesh_device(mesh, device)
    state0, _update, _ = make_streaming_extrap_pipeline(
        1,
        volume0,
        val_shape=(2, *val_shape),
        dtype=dtype,
        bf16=bf16,
        nrep=nrep,
        seed=seed,
        device=device,
        mesh=mesh,
        xla_only=xla_only,
    )

    def _pack(x, d):
        n = x.shape[0]
        return torch.stack([x.reshape(n, *val_shape), d.reshape(n, *val_shape)], dim=1)

    def update(state, wv, xv, dxdqv, weight=None):
        if mesh is None:
            xv = _as_tensor(xv, device)
            dxdqv = _as_tensor(dxdqv, device)
        xshape, dshape = sharded._shape(xv), sharded._shape(dxdqv)
        if xshape != dshape:
            msg = f"xv {xshape} and dxdqv {dshape} must match"
            raise ValueError(msg)
        packed = _pack(xv, dxdqv) if mesh is None else sharded._rec_map(_pack, [xv, dxdqv], mesh)
        return _update(state, wv, packed, weight=weight)

    def _predict_from(s, dalpha, batch_ndim: int):
        # xave (*b, 2, *val): [x means, dxdq means]; dxdu (2, *b, 2, *val)
        xave = s.xave.double()
        x_mean = xave.select(batch_ndim, 0)
        deriv = (s.dxdu.double()[1].select(batch_ndim, 0) + xave.select(batch_ndim, 1)) / v0d
        da = dalpha.reshape((-1,) + (1,) * (batch_ndim + len(val_shape)))
        return x_mean[None] + da * deriv[None]

    def predict(state, volumes):
        mean_s, rep_s, _step = _split_state(state, nrep)
        volumes = torch.atleast_1d(to_device(volumes, device, torch.float64))
        dalpha = volumes - volume0
        pred = _predict_from(mean_s, dalpha, 0)
        if not nrep:
            return pred
        return pred, _predict_from(rep_s, dalpha, 1).std(dim=1, correction=0)

    return state0, update, predict


def make_streaming_perturb_pipeline(
    beta0: float,
    betas,
    *,
    val_shape: tuple[int, ...] = (),
    dtype=torch.float64,
    nrep: int = 0,
    seed: int = 0,
    device=None,
    xla_only: bool = False,
):
    r"""Streaming form of :func:`make_perturb_pipeline`: fold sample chunks
    into per-target exponential-reweighting accumulators, keeping no samples.

    A running perturbation average needs a stable online normalization, so
    the state carries, per target β, the running maximum ``m_a`` of the log
    weights and max-shifted sums (the online-softmax recurrence): when a
    chunk raises the maximum, the old sums are rescaled by ``exp(m_old -
    m_new)`` before the chunk's ``exp(logw - m_new)`` terms are added.  The
    ratio ``num / den`` is the one-shot stabilized reweight up to float
    associativity, for any chunking.  The recurrence is plain tensor code on
    every device.

    The targets ``betas (A,)`` are fixed here (they define the
    accumulators).  ``nrep > 0``: the state also carries replicate sums and
    the chunk counter, each chunk folded into every replicate with
    Poisson(1) counts keyed on ``(seed, chunk index)``, and ``predict``
    returns ``(pred, std)``.  On the card the counts are drawn in the kernel
    (K8, one launch a chunk at the chunk's seed, no count table; its
    float32 sums sent to the state's type); on the CPU they are a table of
    a generator keyed the same way, through the plain version of K7.
    ``xla_only``: the plain route on every device (the seam
    :mod:`.serving_export` traces): the counts of
    :func:`.ops.resample.philox_poisson1_counts`, those K8 draws at the
    chunk's seed, summed in float64 by the plain contraction, with the
    chunk counter a 0-d int64 tensor.  ``dtype``, ``device``: type and
    place of the state; chunks are sent there.

    The state is the tuple ``(m (A,), num (A, V), den (A,))``, with ``nrep``
    followed by ``(bnum (A, nrep, V), bden (A, nrep), step)``.  Returns
    ``(state0, update, predict)``: ``update(state, uv, xv, weight=None) ->
    state`` (zero weights drop samples exactly) and ``predict(state) -> (A,
    *val_shape)`` float64, or ``(pred, std)``.

    Examples
    --------
    >>> import numpy as np
    >>> st, update, predict = make_streaming_perturb_pipeline(
    ...     1.0, np.array([1.0])
    ... )
    >>> st = update(st, np.array([1.0, 2.0]), np.array([2.0, 4.0]))
    >>> st = update(st, np.array([3.0, 4.0]), np.array([6.0, 8.0]))
    >>> float(predict(st)[0])  # at beta0: plain mean
    5.0
    """
    device = default_device() if device is None else torch.device(device)
    val_shape = tuple(val_shape)
    dalpha = torch.atleast_1d(to_device(betas, device, dtype)) - beta0
    a = dalpha.shape[0]
    v = 1
    for n in val_shape:
        v *= int(n)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    state0 = (torch.full((a,), -torch.inf, dtype=dtype, device=device), z(a, v), z(a))
    if nrep:
        state0 += (z(a, nrep, v), z(a, nrep), _step0(device, xla_only))
    counts = _chunk_counts(seed, nrep, device, xla_only)

    def _boot_sums(e, xflat, step):
        """``(A, nrep, V+1)`` replicate sums of one chunk."""
        if xla_only:
            freq = counts(step, e.shape[1])
            return moments_cuda._perturb_sums_plain(e.double(), xflat.double(), freq)
        if e.device.type == "cuda":
            return moments_cuda.resample_perturb_poisson(e, xflat, nrep, seed=_chunk_seed(seed, step))
        gen = validate_rng(_chunk_seed(seed, step), device=device)
        freq = resample.poisson1_freq(gen, (nrep, e.shape[1]), dtype=e.dtype)
        return moments_cuda.resample_perturb_freq(e, xflat, freq)

    def update(state, uv, xv, weight=None):
        uv = _as_tensor(uv, device).to(dtype)
        xflat = _as_tensor(xv, device).to(dtype).reshape(uv.shape[0], -1)
        logw = -dalpha[:, None] * uv[None, :]
        if weight is not None:
            logw += _log_mask(weight, uv)[None, :]
        m = state[0]
        new_m = torch.maximum(m, logw.max(dim=1).values)
        # a target that has seen only zero-weight samples keeps m = -inf; the
        # finite mask keeps exp(-inf - -inf) = NaN out of the recurrence
        finite = torch.isfinite(new_m)
        safe_m = torch.where(finite, new_m, torch.zeros_like(new_m))
        scale = torch.where(finite, torch.exp(m - safe_m), torch.zeros_like(m))
        e = torch.where(finite[:, None], logw.sub_(safe_m[:, None]).exp_(), torch.zeros_like(logw))
        num = scale[:, None] * state[1] + _weighted_sums(e, xflat)
        den = scale * state[2] + e.sum(dim=1)
        if not nrep:
            return new_m, num, den
        bnum, bden, step = state[3:]
        s = _boot_sums(e, xflat, step).to(dtype)
        bnum = scale[:, None, None] * bnum + s[..., :v]
        bden = scale[:, None] * bden + s[..., v]
        return new_m, num, den, bnum, bden, step + 1

    def predict(state):
        pred = (state[1].double() / state[2].double()[:, None]).reshape((a, *val_shape))
        if not nrep:
            return pred
        bpred = state[3].double() / state[4].double()[..., None]
        return pred, bpred.std(dim=1, correction=0).reshape((a, *val_shape))

    return state0, update, predict


def _state_seed(seed: int, i: int) -> int:
    """The base seed of state ``i`` of a streaming interpolation: a
    golden-ratio mix, so that independent simulations share no counts."""
    return int((int(seed) + 0x9E3779B9 * (i + 1)) & 0x7FFFFFFF)


def make_streaming_interp_pipeline(
    order: int,
    beta0s,
    *,
    minus_log: bool = False,
    val_shape: tuple[int, ...] = (),
    dtype=torch.float64,
    bf16: bool = False,
    nrep: int = 0,
    seed: int = 0,
    device=None,
    mesh=None,
):
    r"""Streaming interpolation between states: one online accumulator per
    reference inverse temperature (one simulation per state point), and a
    prediction at any time from the joint polynomial through all states (as
    :class:`.models.extrap.InterpModel`), keeping no samples.

    ``order``: Taylor order of each state (the joint polynomial's is
    ``len(beta0s) * (order + 1) - 1``).  ``beta0s``: the states' inverse
    temperatures, at least two.  ``minus_log``: interpolate ``-log <x>``.
    ``val_shape``, ``dtype``, ``bf16``, ``device``: as in
    :func:`make_streaming_extrap_pipeline`, shared by every state.  ``nrep >
    0``: every state also carries ``nrep`` Poisson-bootstrap replicate
    accumulators (K3 per chunk on CUDA), each state from its own base seed
    ``(seed + 0x9E3779B9 (i+1)) & 0x7FFFFFFF`` and from it a seed per chunk,
    so that no two states share counts.  ``mesh``: every state's chunks
    sharded as in :func:`make_streaming_extrap_pipeline`.

    Returns ``(states0, update, predict)``: ``states0`` a tuple of empty
    states, one per β; ``update(states, i, uv, xv, weight=None) -> states``
    folds a chunk of the simulation at ``beta0s[i]`` (K1 on CUDA);
    ``predict(states, betas) -> (A, *val_shape)`` float64 on the states'
    device, or ``(pred, std)`` with ``nrep``: every state's unnormalized
    derivative stack, then one float64 solve of the joint system on the
    device (:func:`.models.extrap._interp_fit`), the replicate axis
    riding its right-hand side.  ``predict`` composes with
    :func:`streaming_jackknife` over one state's chunks.
    """
    beta0s = [float(b) for b in beta0s]
    if len(beta0s) < 2:
        msg = f"interpolation needs >= 2 reference states, got {len(beta0s)}"
        raise ValueError(msg)
    device = _mesh_device(mesh, device)
    pipes = [
        make_streaming_extrap_pipeline(
            order,
            b,
            val_shape=val_shape,
            dtype=dtype,
            bf16=bf16,
            nrep=nrep,
            seed=_state_seed(seed, i),
            device=device,
            mesh=mesh,
        )
        for i, b in enumerate(beta0s)
    ]
    states0 = tuple(p[0] for p in pipes)

    def update(states, i, uv, xv, weight=None):
        i = int(i)
        states = list(states)
        states[i] = pipes[i][1](states[i], uv, xv, weight=weight)
        return tuple(states)

    def _derivs(s):
        c = central_x_ave_coefs(s.xave.double(), s.du.double(), s.dxdu.double(), order)
        return derivs_from_coefs(series_neg_log(c) if minus_log else c)

    def _solve_eval(data_states, betas):
        return _interp_eval(_interp_fit(beta0s, [_derivs(s) for s in data_states], order), betas)

    def predict(states, betas):
        betas = torch.atleast_1d(to_device(betas, device, torch.float64))
        if not nrep:
            return _solve_eval(states, betas)
        pred = _solve_eval([s[0] for s in states], betas)
        bpred = _solve_eval([s[1] for s in states], betas)  # (A, nrep, *val)
        return pred, bpred.std(dim=1, correction=0)

    return states0, update, predict


def streaming_jackknife(states, predict, *args):
    r"""Delete-one-block jackknife over retained per-chunk states: a
    prediction and its standard error with no sample retention.

    Every leave-one-chunk-out pooled state is built from prefix and suffix
    exact merges (``O(C)`` merges), ``predict(state, *args)`` is evaluated on
    each, and the block-jackknife variance ``(C-1)/C sum_i (theta_i -
    mean)^2`` is returned.  For time-correlated streams, where each chunk is
    a correlation block, this is the appropriate estimator.

    ``states``: per-chunk :class:`.data.DataCentralMoments` of one structure.
    Returns ``(pred, std_err)``: ``pred`` from the pool of all chunks.
    """
    states = list(states)
    c = len(states)
    if c < 2:
        msg = f"jackknife needs >= 2 chunk states, got {c}"
        raise ValueError(msg)
    # prefix[i] pools states[:i], suffix[i] pools states[i:]
    prefix = [None] * (c + 1)
    suffix = [None] * (c + 1)
    for i, s in enumerate(states):
        prefix[i + 1] = s if prefix[i] is None else prefix[i].merge(s)
    for i in range(c - 1, -1, -1):
        suffix[i] = states[i] if suffix[i + 1] is None else states[i].merge(suffix[i + 1])
    loo = []
    for i in range(c):
        if prefix[i] is None:
            loo.append(suffix[i + 1])
        elif suffix[i + 1] is None:
            loo.append(prefix[i])
        else:
            loo.append(prefix[i].merge(suffix[i + 1]))
    theta = torch.stack([predict(s, *args) for s in loo])
    var = (c - 1) / c * ((theta - theta.mean(dim=0)) ** 2).sum(dim=0)
    return predict(prefix[c], *args), torch.sqrt(var)


def make_gpr_pipeline(
    states,
    *,
    log_scale: bool = False,
    base_kwargs=None,
    start_params=None,
    orders=(0,),
    bucket: int = 64,
):
    """Train a derivative-informed GPR on extrapolation states and return
    ``(gpr, predict)``, a posterior serving closure.

    The GP runs in float64 on the GPR device
    (:func:`.utils.compute.compute_device`: the card when there is one).
    The JAX package pads each query grid to a multiple of ``bucket`` so that
    a stream of ragged grids reuses a few compiled programs; torch compiles
    nothing, and each query point's posterior is independent of the others,
    so the padding is dropped here and the outputs are those of the padded
    call.  ``bucket`` keeps its check (a positive integer).

    Parameters
    ----------
    states : sequence of ``ExtrapModel`` (or callables returning
        ``(x, y, cov)``) — the training states, as for ``create_GPR``.
    log_scale : train on log10-transformed locations/derivatives
        (``gpr_active.active_utils.input_GP_from_state``); ``predict``
        applies the same location transform, and its outputs stay in the
        transformed y-space.
    base_kwargs, start_params : forwarded to ``create_GPR``.
    orders : derivative orders ``predict`` may be asked for (order 0 = the
        observable itself).
    bucket : the JAX package's query-grid quantum, checked and not used.

    Returns
    -------
    ``(gpr, predict)`` with ``predict(alphas, order=0) -> (mean, var)``,
    each ``(len(alphas), out_dim)`` float64 numpy arrays.
    """
    import numpy as np

    from .gpr_active.active_utils import create_GPR

    if int(bucket) != bucket or bucket < 1:
        msg = f"bucket must be a positive integer, got {bucket!r}"
        raise ValueError(msg)
    orders = tuple(int(o) for o in orders)
    gpr = create_GPR(list(states), log_scale=log_scale, start_params=start_params, base_kwargs=base_kwargs)

    def predict(alphas, order: int = 0):
        if order not in orders:
            msg = f"{order=} not in the pipeline's static {orders=}"
            raise ValueError(msg)
        locs = np.atleast_1d(np.asarray(host_numpy(alphas), dtype=np.float64))
        if locs.shape[0] == 0:
            empty = np.zeros((0, int(gpr.out_dim)), dtype=np.float64)
            return empty, empty.copy()
        if log_scale:
            locs = np.log10(locs)
        x_new = np.column_stack([locs, np.full(locs.shape[0], order, np.float64)])
        mean, var = gpr.predict_f(x_new)
        return host_numpy(mean), host_numpy(var)

    return gpr, predict


# ---------------------------------------------------------------------------
# bucketed serving
# ---------------------------------------------------------------------------


def normalize_buckets(buckets) -> tuple:
    """Sorted bucket table; by default the powers of two ``2^12 .. 2^27``."""
    return tuple(1 << p for p in range(12, 28)) if buckets is None else tuple(sorted(int(b) for b in buckets))


def bucket_pad(uv, xv, weight, buckets):
    """Pad ``(uv, xv, weight)`` with zero-weight samples up to the smallest
    bucket ``>= R`` (unchanged past the largest bucket).

    Arrays that are not tensors go to the default device first; tensors are
    padded on their own device by ``torch.cat`` (a 1e8-sample request does
    not pass through host memory).  ``xv=None`` passes through (the
    ``x_is_u`` runner has no observable stream), and ``xv`` may be a tuple of
    value streams padded together.  Exact: a pad replicates the last sample
    (a bfloat16 stream stays in distribution) and carries weight 0.  Weights
    keep their floating dtype (all ones of ``promote(uv.dtype, float32)``
    without a weight); integer weights become float32.  Returns ``(uv, xv,
    weight)``.
    """
    multi = isinstance(xv, tuple)
    uv = _as_tensor(uv)
    if multi:
        if not xv:
            msg = "bucket_pad: a tuple of value streams may not be empty"
            raise ValueError(msg)
        if any(x is None for x in xv):
            msg = "bucket_pad: a tuple of value streams may not contain None"
            raise ValueError(msg)
        xvs = tuple(_as_tensor(x, uv.device) for x in xv)
    else:
        xvs = () if xv is None else (_as_tensor(xv, uv.device),)
    r = uv.shape[0]
    if r == 0:
        msg = "serve() needs at least one sample"
        raise ValueError(msg)
    if weight is None:
        w = torch.ones(r, dtype=torch.promote_types(uv.dtype, torch.float32), device=uv.device)
    else:
        w = _as_tensor(weight, uv.device)
        if not w.is_floating_point():
            w = w.float()
    rp = next((b for b in buckets if b >= r), r)
    pad = rp - r
    if pad:

        def _pad(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

        uv = _pad(uv)
        xvs = tuple(_pad(x) for x in xvs)
        w = torch.cat([w, w.new_zeros(pad)])
    return uv, (xvs if multi else (xvs[0] if xvs else None)), w


def make_bucketed_extrap_runner(
    order: int,
    beta0: float,
    *,
    buckets=None,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    nrep: int = 0,
    bf16: bool = False,
):
    r"""Serving wrapper around the weighted :func:`make_extrap_pipeline` that
    pads every request with zero-weight samples up to a bucket of sample
    counts (:func:`bucket_pad`), so that requests of any size take a few
    fixed shapes.  A zero-weight sample adds nothing to the reduction, so the
    mean is the unpadded call's up to the order of the sums (on the card the
    kernels' blocks move with the length).  With ``nrep`` the bootstrap is
    over the padded stream: on CUDA Poisson(1) counts (K3, or K5 with
    ``x_is_u``), whose pads weigh nothing; on CPU the multinomial count table
    of :func:`make_extrap_pipeline` over the padded length.

    ``buckets``: increasing sample counts, by default ``2^12 .. 2^27``; a
    request above the largest runs at its own length.  ``order``, ``beta0``,
    ``minus_log``, ``xalpha``, ``x_is_u``, ``nrep``, ``bf16``: as in
    :func:`make_extrap_pipeline`.

    Returns ``serve(uv, xv, betas, weight=None, seed=0)`` (``serve(uv, betas,
    weight=None, seed=0)`` with ``x_is_u``), with ``serve.buckets`` and
    ``serve.warmup(val_shape=(1,), n_betas=1, max_bucket=None,
    dtype=torch.float32)``, which runs each bucket once on the default device
    (on CUDA that builds the kernels; no bucket compiles anything of its
    own).

    Examples
    --------
    >>> import numpy as np
    >>> serve = make_bucketed_extrap_runner(2, 1.0, buckets=(8, 16))
    >>> uv = np.array([1.0, 2.0, 3.0, 4.0, 5.0])   # R=5 -> bucket 8
    >>> pred = serve(uv, 2.0 * uv[:, None], np.array([1.0]))
    >>> float(pred[0, 0])
    6.0
    """
    run = make_extrap_pipeline(
        order, beta0, minus_log=minus_log, xalpha=xalpha, x_is_u=x_is_u, nrep=nrep, weighted=True, bf16=bf16
    )
    buckets = normalize_buckets(buckets)

    if x_is_u:

        def serve(uv, betas, weight=None, seed=0):
            uvp, _, wp = bucket_pad(uv, None, weight, buckets)
            return run(uvp, betas, wp, seed)

    else:

        def serve(uv, xv, betas, weight=None, seed=0):
            uvp, xvp, wp = bucket_pad(uv, xv, weight, buckets)
            return run(uvp, xvp, betas, wp, seed)

    def warmup(val_shape=(1,), n_betas: int = 1, max_bucket: int | None = None, dtype=torch.float32):
        """Run each bucket (up to ``max_bucket``) once on dummy samples of
        ``dtype`` on the default device."""
        device = default_device()
        betas = torch.full((n_betas,), float(beta0), dtype=torch.float64)
        for b in buckets:
            if max_bucket is not None and b > max_bucket:
                break
            uv = torch.linspace(0.5, 1.5, b, dtype=dtype, device=device)
            if x_is_u:
                serve(uv, betas)
            else:
                xv_shape = (b, order + 1, *val_shape) if xalpha else (b, *val_shape)
                serve(uv, torch.ones(xv_shape, dtype=dtype, device=device), betas)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    serve.warmup = warmup
    serve.buckets = buckets
    return serve

r"""Serving of trained derivative-informed GPR models from frozen constants
(counterpart of ``thermoextrap_tpu/gpr_active/serving.py``).

Posterior prediction needs no factorization once the training-side solves
are frozen.  With

.. math::

    w      &= (K + S)^{-1} (y - m)            \\
    L^{-1} &: \; L L^\top = K + S

precomputed per output dim (``N`` ~ tens of training rows), the posterior at
``M`` query points is

.. math::

    \mu_*      &= k_*^\top w + m_*  \\
    \sigma_*^2 &= k_{**} - \lVert L^{-1} k_* \rVert^2

— one ``(N, M)`` kernel block at a fixed query derivative order and two
matrix products.

- The freeze runs in float64 on :func:`..utils.compute.compute_device` (the
  card when there is one): one ``cholesky_ex``, the two triangular solves
  and ``L^{-1}``.  Only the frozen constants are cast to the serving dtype,
  float32 by default; float64 is accepted as well (torch has it on every
  device) and reproduces :meth:`HeteroscedasticGPR.predict_f` to ~1e-12.
- Float32 cancellation can drive the posterior variance slightly negative
  at near-interpolated points; the served variance is clamped at 0 (the
  ``predict_f`` path does not clamp).
- Queries are independent rows, so they shard over a device mesh: a
  ``DTensor`` of locations sharded on its rows (``parallel.shard_rec``)
  is predicted block by block on each rank and comes back sharded as it
  went in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.compute import compute_device
from ..utils.device import is_dtensor
from .gp_models import (
    ConstantMeanWithDerivs,
    HeteroscedasticGPR,
    HeteroscedasticGPRAnalyticalScale,
    LinearWithDerivs,
    SympyMeanFunc,
    _build_param_split,
    _cholesky,
    _f64,
    _full,
    _scaled_noise_cov,
    _solve_lower,
)

__all__ = ["FrozenGPRPredictor", "freeze_predictor"]


def _frozen_mean_fn(mean_function, d_new, out_dim, dtype, device):
    """The mean function at a FIXED query derivative order ``d_new``:
    ``f(locs (M, obs)) -> (M, out_dim)`` of actual (unscaled) mean values,
    as tensors of ``dtype`` on ``device``."""
    is_zero = all(d == 0 for d in d_new)

    def zeros(locs):
        return torch.zeros((locs.shape[0], out_dim), dtype=dtype, device=device)

    if mean_function is None:
        return zeros

    if isinstance(mean_function, ConstantMeanWithDerivs):
        if not is_zero:
            return zeros
        c = torch.as_tensor(np.asarray(mean_function.c, dtype=np.float64), device=device).to(dtype)

        def const(locs):
            return torch.broadcast_to(c[None, :], (locs.shape[0], out_dim))

        return const

    if isinstance(mean_function, LinearWithDerivs):
        slope = torch.as_tensor(np.asarray(mean_function.slope, dtype=np.float64), device=device).to(dtype)
        b = torch.as_tensor(np.asarray(mean_function.b, dtype=np.float64), device=device).to(dtype)
        d_arr = np.asarray(d_new, dtype=np.float64)
        if is_zero:
            return lambda locs: locs @ slope + b
        if np.any(d_arr == 1.0) and np.all(d_arr < 2.0):
            row = torch.as_tensor(d_arr, device=device).to(dtype) @ slope
            return lambda locs: torch.broadcast_to(row[None, :], (locs.shape[0], out_dim))
        return zeros

    if isinstance(mean_function, SympyMeanFunc):
        fn = mean_function._fn(tuple(int(d) for d in d_new))
        pvals = [torch.tensor(mean_function.param_values[s.name], dtype=dtype, device=device) for s in mean_function.param_syms]

        def sym(locs):
            cols = [locs[:, k] for k in range(locs.shape[1])]
            vals = _full(fn(*cols, *pvals), (locs.shape[0],), locs)
            return torch.broadcast_to(vals[:, None], (locs.shape[0], out_dim))

        return sym

    msg = (
        f"cannot freeze mean function {type(mean_function).__name__}: its "
        "value at the query derivative order is not known. Pass "
        "mean_new_fn=, a locs (M, obs) -> (M, out_dim) callable returning the "
        "mean at the query derivative order."
    )
    raise TypeError(msg)


class FrozenGPRPredictor:
    """A trained GPR frozen for serving: ``predictor(locs) -> (mean, var)``.

    Built by :func:`freeze_predictor`; holds the precomputed posterior
    weights in the serving dtype on the device of the freeze.  ``locs`` is
    ``(M, obs_dims)`` (a bare ``(M,)`` is accepted when ``obs_dims == 1``),
    numpy, a tensor, or a ``DTensor`` sharded on its rows; outputs are
    ``(M, out_dim)`` tensors each (a ``DTensor`` each, placed as a sharded
    input).

    ``predict_fn`` is the raw closure over a tensor of the serving dtype on
    that device.
    """

    def __init__(self, predict_fn, *, meta: dict, device):
        self.predict_fn = predict_fn
        self.meta = dict(meta)
        self.device = torch.device(device)

    @property
    def obs_dims(self) -> int:
        return self.meta["obs_dims"]

    def __call__(self, locs):
        if is_dtensor(locs):
            return self._sharded(locs)
        dtype = getattr(torch, self.meta["dtype"])
        if isinstance(locs, torch.Tensor):
            locs = locs.to(device=self.device, dtype=dtype)
        else:
            locs = torch.as_tensor(np.asarray(locs), device=self.device).to(dtype)
        if locs.ndim == 1:
            if self.obs_dims != 1:
                msg = f"locs must be (M, {self.obs_dims}) for this model"
                raise ValueError(msg)
            locs = locs[:, None]
        if locs.ndim != 2 or locs.shape[1] != self.obs_dims:
            msg = f"locs must be (M, {self.obs_dims}), got {tuple(locs.shape)}"
            raise ValueError(msg)
        return self.predict_fn(locs)

    def _sharded(self, locs):
        """Each rank's rows of a row-sharded ``DTensor`` of locations, as
        ``DTensor`` pair ``(mean, var)`` placed as the input."""
        from torch.distributed.tensor import DTensor, Shard

        if any(isinstance(p, Shard) and p.dim != 0 for p in locs.placements):
            msg = f"sharded queries split their rows only, got placements {locs.placements}"
            raise ValueError(msg)
        if locs.device_mesh.device_type != self.device.type:
            msg = f"a {locs.device_mesh.device_type} mesh cannot serve a predictor frozen on {self.device}"
            raise ValueError(msg)
        m = locs.shape[0]
        return tuple(
            DTensor.from_local(o, locs.device_mesh, locs.placements, shape=torch.Size((m, o.shape[1])), stride=(o.shape[1], 1))
            for o in self(locs.to_local())
        )


def freeze_predictor(model, d_new=None, *, dtype=torch.float32, mean_new_fn=None) -> FrozenGPRPredictor:
    r"""Freeze a trained :class:`~.gp_models.HeteroscedasticGPR` into a
    posterior predictor on the GPR device.

    The training-side solves run once in float64 on
    :func:`..utils.compute.compute_device` (Cholesky of the noisy Gram per
    output dim); the returned predictor evaluates posterior mean and
    variance from the frozen ``(K+S)^{-1}(y-m)`` and ``L^{-1}`` with one
    kernel block and two products.

    Parameters
    ----------
    model :
        A (trained) ``HeteroscedasticGPR`` or subclass.  The
        ``HeteroscedasticGPRAnalyticalScale`` profiled variance scale
        ``v* = err^T (K+S)^{-1} err / N`` is folded in automatically.
    d_new :
        Fixed query derivative order, one int per observable dim (default:
        all zeros — predict the function itself).  Build one predictor per
        order you serve.
    dtype :
        Serving dtype of the frozen constants and the kernel block
        (``torch.float32`` by default, or ``torch.float64``).
    mean_new_fn :
        Override for the frozen mean: ``locs (M, obs) -> (M, out_dim)``
        returning actual mean values at ``d_new``.  Required for custom
        mean-function types.
    """
    if not isinstance(model, HeteroscedasticGPR):
        msg = (
            "freeze_predictor supports HeteroscedasticGPR models (the "
            f"experimental noise-GP variants train their own noise model); "
            f"got {type(model).__name__}"
        )
        raise TypeError(msg)
    obs = model.kernel.obs_dims
    d_new = (0,) * obs if d_new is None else tuple(int(d) for d in d_new)
    if len(d_new) != obs:
        msg = f"d_new must have {obs} entries, got {d_new}"
        raise ValueError(msg)
    if dtype not in (torch.float32, torch.float64):
        msg = f"dtype must be torch.float32 or torch.float64, got {dtype}"
        raise ValueError(msg)

    # ---- the float64 freeze: fold the training-side solves -----------------
    device = compute_device()
    fixed, locs, gid, y, cov, dplus, mean_x = model._bound_args()
    kernel_p, lik_p = _build_param_split(model._spec_struct())(_f64(model.get_unconstrained(), device), fixed)
    pvals64 = [kernel_p[k] for k in model.kernel.params]
    groups = model._groups
    kmm = model.kernel._pair_matrix(locs, gid, groups, locs, gid, groups, pvals64)
    chol = _cholesky(kmm[None] + _scaled_noise_cov(cov, dplus, lik_p, float(model.likelihood.stable_var_min)))  # (D, N, N)
    err = (y - mean_x).mT[..., None]  # (D, N, 1)
    b = _solve_lower(chol, err)
    w = torch.linalg.solve_triangular(chol.mT, b, upper=True)[..., 0]  # (D, N) = (K+S)^{-1} err
    # the WHITENED variance form ||L^{-1} k_*||^2 (not the folded (K+S)^{-1})
    # keeps the float32 error ~ eps * sqrt(cond) instead of eps * cond
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=device).expand_as(chol)
    linv = _solve_lower(chol, eye)
    if isinstance(model, HeteroscedasticGPRAnalyticalScale):
        v = torch.sum(b[..., 0] ** 2, dim=1) / err.shape[1]  # (D,)
    else:
        v = torch.ones(err.shape[0], dtype=torch.float64, device=device)
    scale64 = _f64(model.scale_fac, device)

    # ---- the frozen constants, in the serving dtype ------------------------
    locs_c, w_c, linv_c = locs.to(dtype), w.to(dtype), linv.to(dtype)
    var_scale_c = (v * scale64**2).to(dtype)
    scale_c = scale64.to(dtype)
    pvals_c = [p.to(dtype) for p in pvals64]
    if mean_new_fn is None:
        mean_new_fn = _frozen_mean_fn(model.mean_function, d_new, model.out_dim, dtype, device)
    kernel = model.kernel
    groups_new = (d_new,)

    def predict(locs_new):
        m = locs_new.shape[0]
        gid_new = torch.zeros((m,), dtype=torch.int64, device=locs_new.device)
        kmn = kernel._pair_matrix(locs_c, gid, groups, locs_new, gid_new, groups_new, pvals_c)  # (N, M)
        mean = (w_c @ kmn).T * scale_c[None, :] + mean_new_fn(locs_new)
        a = torch.matmul(linv_c, kmn)  # (D, N, M) whitened
        knn = kernel._pair_diag(locs_new, gid_new, groups_new, pvals_c)  # (M,)
        var = torch.clamp(knn[None, :] - torch.sum(a * a, dim=1), min=0.0) * var_scale_c[:, None]
        return mean, var.T

    meta = {
        "obs_dims": obs,
        "out_dim": model.out_dim,
        "d_new": d_new,
        "dtype": str(dtype).removeprefix("torch."),
        "n_train": int(model._locs_np.shape[0]),
        "analytic_scale": isinstance(model, HeteroscedasticGPRAnalyticalScale),
    }
    return FrozenGPRPredictor(predict, meta=meta, device=device)

r"""Active-learning utilities for derivative-informed GPR (counterpart of
``thermoextrap_tpu/gpr_active/active_utils.py``).

- GP input assembly from extrapolation states: each state's derivatives
  and its bootstrap replicates run on the state's device (K1 for the
  reduction, K2 for the count-table bootstrap on the card) and are read
  back once each, as numpy; the bootstrap covariance is ``np.cov`` on the
  host;
- ``DataWrapper`` / ``SimWrapper`` — host-side file and process plumbing
  around simulations;
- ``create_base_GP_model``, ``train_GPR`` and ``create_GPR``;
- update policies (ALM brute force, random, space-filling, adaptive
  integrate, experimental ALC), stopping metrics (variance and deviation
  families, the Ishibashi–Hino ``ErrorStability``, ``MaxIter``) and
  ``StopCriteria``;
- the outer ``active_learning`` loop with warm-started refits and the
  ``.npz`` history of :func:`load_active_history`.

The policies and metrics work on numpy at the GP boundary, as the JAX
package does: each grid prediction (mean and variance, or mean and full
covariance) comes back from the GPR device in one read.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path

import numpy as np
import torch

from ..models.extrap import ExtrapModel
from ..utils import trace
from ..utils.device import host_numpy
from ..utils.random import validate_rng
from .gp_models import (
    ConstantMeanWithDerivs,
    HeteroscedasticGPR,
    LinearWithDerivs,
)

# kernel factories live in .kernels; the reference defines them in
# active_utils, so re-export for import parity
from .kernels import (
    ChangeInnerOuterRBFDerivKernel,
    RBFDerivKernel,
    make_matern_expr,
    make_poly_expr,
    make_rbf_expr,
)

logger = logging.getLogger(__name__)

__all__ = [
    "AvgAbsRelDeviation",
    "AvgRelVar",
    "AvgVar",
    "ChangeInnerOuterRBFDerivKernel",
    "DataWrapper",
    "ErrorStability",
    "MSD",
    "MaxAbsRelDeviation",
    "MaxAbsRelGlobalDeviation",
    "MaxIter",
    "MaxRelGlobalVar",
    "MaxRelVar",
    "MaxVar",
    "MetricBase",
    "RBFDerivKernel",
    "SimWrapper",
    "StopCriteria",
    "UpdateALCbrute",
    "UpdateALMbrute",
    "UpdateAdaptiveIntegrate",
    "UpdateFuncBase",
    "UpdateRandom",
    "UpdateSpaceFill",
    "UpdateStopABC",
    "active_learning",
    "create_GPR",
    "create_base_GP_model",
    "get_logweights",
    "identityTransform",
    "input_GP_from_state",
    "load_active_history",
    "make_matern_expr",
    "make_poly_expr",
    "make_rbf_expr",
    "train_GPR",
]

def get_logweights(bias):
    """Unbiasing log weights from bias-potential values."""
    bias = np.asarray(host_numpy(bias))
    bias_max = np.max(bias)
    log_denom = np.log(np.sum(np.exp(bias - bias_max))) + bias_max
    return bias - log_denom


def identityTransform(x, y, y_var):  # noqa: N802 - reference name
    """Default output transform."""
    y_std = np.sqrt(y_var)
    conf_int = [y - 2.0 * y_std, y + 2.0 * y_std]
    return y, y_std, conf_int


def _log_scale_transform(derivs, boot_derivs, alpha0):
    """Faa di Bruno change of variable beta -> log10(beta) on derivative
    stacks.  For the geometric argument sequence the Bell polynomial has the
    closed form ``a**k * ln10**n * S(n, k)`` with ``S`` the Stirling numbers
    of the second kind (``B_{n,k}(a c, a c^2, ...) = a^k c^n B_{n,k}(1, 1,
    ...)``), so no sympy runs here.
    """
    order = derivs.shape[0] - 1
    out = np.zeros_like(derivs)
    out_boot = np.zeros_like(boot_derivs)
    out[0] = derivs[0]
    out_boot[0] = boot_derivs[0]
    ln10 = np.log(10.0)
    for n in range(1, order + 1):
        for k in range(1, n + 1):
            bell_fac = alpha0**k * ln10**n * _stirling2(n, k)
            out[n] += derivs[k] * bell_fac
            out_boot[n] += boot_derivs[k] * bell_fac
    return out, out_boot


@functools.lru_cache(maxsize=None)
def _stirling2(n: int, k: int) -> int:
    """Stirling numbers of the second kind, ``S(n, k)``, by the standard
    recurrence ``S(n, k) = k S(n-1, k) + S(n-1, k-1)``."""
    if n == 0 and k == 0:
        return 1
    if k == 0 or k > n:
        return 0
    return k * _stirling2(n - 1, k) + _stirling2(n - 1, k - 1)


def input_GP_from_state(state: ExtrapModel, n_rep: int = 100, log_scale: bool = False, rng=None):  # noqa: N802
    """Assemble GP input (X, Y, per-dim bootstrap covariance) from an
    extrapolation state, as numpy float64.

    ``rng`` (a ``torch.Generator``, an integer seed or None) draws the
    bootstrap's index table of a values-backed state; None draws it from the
    package's fixed default seed, so every such state gets the same table.

    Returns ``x_data (order+1, 2)``, ``y_data (order+1, Dy)``,
    ``cov_data (Dy, order+1, order+1)``.
    """
    alphas = state.alpha0 * np.ones((state.order + 1, 1))
    if log_scale:
        alphas = np.log10(alphas)
    x_data = np.concatenate([alphas, np.arange(state.order + 1)[:, None]], axis=1)

    derivs = host_numpy(state.derivs())
    uv = getattr(state.data, "uv", None)
    # replicate axis: batch dims on the values (uv.ndim > 1) or, for
    # moment-backed data (uv absent, e.g. from_resample_vals), batch dims
    # on the pooled weight (wsum.ndim >= 1)
    has_rep = np.ndim(uv) > 1 if uv is not None else np.ndim(getattr(state.data, "wsum", 0.0)) >= 1
    if uv is not None and not has_rep:
        # values-backed data: bootstrap replicates through the count table
        boot = host_numpy(state.resample({"nrep": n_rep, "rng": rng}).derivs())
    elif has_rep and derivs.ndim >= 2:
        # data already carries a replicate batch axis (axis 1 of derivs)
        boot = derivs
        derivs = derivs.mean(axis=1)
    else:
        msg = "state data must be values-backed or carry a replicate axis"
        raise ValueError(msg)

    # normalize shapes to (order+1, Dy) and (order+1, nrep, Dy); multi-dim
    # observables flatten their val axes into output dims
    if derivs.ndim == 1:
        derivs = derivs[:, None]
    elif derivs.ndim > 2:
        derivs = derivs.reshape(derivs.shape[0], -1)
    if boot.ndim == 2:
        boot = boot[:, :, None]
    elif boot.ndim > 3:
        boot = boot.reshape(boot.shape[0], boot.shape[1], -1)

    if log_scale:
        derivs, boot = _log_scale_transform(derivs, boot, state.alpha0)

    y_data = derivs
    cov_data = np.array([np.cov(boot[:, :, k]) for k in range(boot.shape[-1])])
    return x_data, y_data, cov_data


# ---------------------------------------------------------------------------
# file / simulation wrappers
# ---------------------------------------------------------------------------


class DataWrapper:
    """File-backed data loader: decorrelate, unbias, build an extrapolation
    state (on the default device)."""

    def __init__(
        self,
        sim_info_files,
        cv_bias_files,
        beta,
        x_files=None,
        n_frames: int = 10_000,
        u_col: int = 2,
        cv_cols=None,
        x_col=None,
    ) -> None:
        self.sim_info_files = list(sim_info_files)
        self.cv_bias_files = list(cv_bias_files)
        self.beta = float(beta)
        self.x_files = None if x_files is None else list(x_files)
        self.n_frames = int(n_frames)
        self.u_col = int(u_col)
        self.cv_cols = [1, 2] if cv_cols is None else list(cv_cols)
        self.x_col = [1] if x_col is None else ([int(x_col)] if np.isscalar(x_col) else list(x_col))

    def load_U_info(self):  # noqa: N802 - reference name
        from ..native import loadtxt_fast

        u = [np.atleast_2d(loadtxt_fast(f))[-self.n_frames :, self.u_col] for f in self.sim_info_files]
        return np.hstack(u)

    def load_CV_info(self):  # noqa: N802
        from ..native import loadtxt_fast

        vals, bias = [], []
        for f in self.cv_bias_files:
            info = np.atleast_2d(loadtxt_fast(f))[-self.n_frames :, self.cv_cols]
            vals.append(info[:, 0])
            bias.append(info[:, 1])
        return np.hstack(vals), np.hstack(bias)

    def load_x_info(self):
        from ..native import loadtxt_fast

        x = [np.atleast_2d(loadtxt_fast(f))[-self.n_frames :, self.x_col] for f in self.x_files]
        return np.vstack(x)

    def get_data(self):
        """Load, decorrelate (the FFT statistical inefficiency of
        :mod:`..models.mbar`, float64), and unbias; numpy out."""
        from ..models.mbar import statistical_inefficiency

        tot_pot = self.load_U_info()
        cv, bias = self.load_CV_info()
        x = self.load_x_info() if self.x_files is not None else cv[:, None]
        pot = tot_pot - bias

        g_max = float(statistical_inefficiency(pot))
        for k in range(x.shape[1]):
            g_max = max(g_max, float(statistical_inefficiency(x[:, k])))
            # cross x-pot correlation can decay slower than either marginal
            g_max = max(g_max, float(statistical_inefficiency(x[:, k], pot)))
        stride = max(int(np.ceil(g_max)), 1)
        uncorr = np.arange(0, x.shape[0], stride)

        x = x[uncorr, :]
        bias = bias[uncorr]
        pot = pot[uncorr]
        w = np.exp(get_logweights(self.beta * bias))
        return pot, x, w

    def build_state(self, all_data=None, max_order: int = 6):
        """The extrapolation state of ``(pot, x, w)`` (numpy arrays or
        tensors; numpy goes to the default device)."""
        from .. import beta as beta_xpan
        from ..data import DataCentralMomentsVals

        if all_data is None:
            all_data = self.get_data()
        pot, x, w = all_data
        data = DataCentralMomentsVals.from_vals(x, pot, order=max_order, weight=w)
        return beta_xpan.factory_extrapmodel(self.beta, data)


class SimWrapper:
    """Spawn simulation repeats as processes and wrap outputs (host side by
    design — simulations are external programs)."""

    def __init__(
        self,
        sim_func,
        struc_name=None,
        sys_name=None,
        info_name="sim_info.txt",
        bias_name="cv_bias.txt",
        kw_inputs=None,
        data_class=DataWrapper,
        data_kw_inputs=None,
        post_process_func=None,
        post_process_out_name=None,
        post_process_kw_inputs=None,
        pre_process_func=None,
    ) -> None:
        self.sim_func = sim_func
        self.struc_name = struc_name
        self.sys_name = sys_name
        self.info_name = info_name
        self.bias_name = bias_name
        self.kw_inputs = kw_inputs or {}
        self.data_class = data_class
        self.data_kw_inputs = data_kw_inputs or {}
        self.post_process_func = post_process_func
        self.post_process_out_name = post_process_out_name
        self.post_process_kw_inputs = post_process_kw_inputs or {}
        self.pre_process_func = pre_process_func

    def run_sim(self, sim_dir, alpha, n_repeats: int = 1, **extra_kwargs):
        """Run ``n_repeats`` simulations concurrently via multiprocessing,
        join, check exit codes, and wrap outputs in ``data_class``."""
        import multiprocessing
        import time

        # spawn (not fork): torch is multithreaded and fork() risks deadlock
        ctx = multiprocessing.get_context("spawn")

        sim_dir = Path(sim_dir)
        sim_dir.mkdir(parents=True, exist_ok=True)

        if self.pre_process_func is not None:
            self.pre_process_func(sim_dir, alpha, **extra_kwargs)

        procs = []
        info_files, bias_files = [], []
        for rep in range(n_repeats):
            rep_dir = sim_dir / f"rep_{rep}"
            rep_dir.mkdir(parents=True, exist_ok=True)
            kws = dict(self.kw_inputs)
            kws.update(extra_kwargs)
            p = ctx.Process(target=self.sim_func, args=(str(rep_dir), alpha), kwargs=kws)
            p.start()
            procs.append(p)
            info_files.append(str(rep_dir / self.info_name))
            bias_files.append(str(rep_dir / self.bias_name))
            time.sleep(0.05)  # decorrelate time-based seeds

        for p in procs:
            p.join()
        for p in procs:
            if p.exitcode != 0:
                msg = f"simulation process exited with code {p.exitcode}"
                raise RuntimeError(msg)

        if self.post_process_func is not None:
            self.post_process_func(sim_dir, **self.post_process_kw_inputs)

        return self.data_class(info_files, bias_files, alpha, **self.data_kw_inputs)


# ---------------------------------------------------------------------------
# GP model assembly and training
# ---------------------------------------------------------------------------


def create_base_GP_model(  # noqa: N802 - reference name
    gpr_data,
    d_order_ref: int = 0,
    shared_kernel: bool = True,
    kernel=RBFDerivKernel,
    mean_func=None,
    likelihood_kwargs=None,
    model_class=None,
):
    """Untrained HeteroscedasticGPR with auto mean function and output
    scaling.  ``model_class`` swaps the GP model (e.g.
    ``HeteroscedasticGPRAnalyticalScale``); it must accept the same
    ``(data, kernel=, scale_fac=, mean_function=, likelihood_kwargs=)``
    signature."""
    n_x_dims = gpr_data[0].shape[1] // 2
    ref_d_bool = np.all(gpr_data[0][:, n_x_dims:] == d_order_ref, axis=-1)

    if mean_func is None:
        if d_order_ref == 0:
            if len(np.unique(gpr_data[0][ref_d_bool, :n_x_dims], axis=0)) > 2:
                mean_func = LinearWithDerivs(gpr_data[0][ref_d_bool, :n_x_dims], gpr_data[1][ref_d_bool, :])
            else:
                mean_func = ConstantMeanWithDerivs(gpr_data[1][ref_d_bool, :], x_dim=n_x_dims)
        else:
            mean_func = ConstantMeanWithDerivs(np.zeros_like(gpr_data[1][ref_d_bool, :]), x_dim=n_x_dims)

    if len(np.unique(gpr_data[0][ref_d_bool, :n_x_dims], axis=0)) > 1:
        std_scale = np.std(
            gpr_data[1][ref_d_bool, :] - host_numpy(mean_func(gpr_data[0][ref_d_bool, :])),
            axis=0,
        )
        std_scale = np.where(std_scale > 0, std_scale, 1.0)
    else:
        std_scale = 1.0

    kern = kernel() if isinstance(kernel, type) else kernel
    cls = HeteroscedasticGPR if model_class is None else model_class
    return cls(
        gpr_data,
        kernel=kern,
        scale_fac=std_scale,
        mean_function=mean_func,
        likelihood_kwargs=likelihood_kwargs or {},
    )


def train_GPR(gpr, record_loss: bool = False, start_params=None, on_device: bool = False):  # noqa: N802
    """Train with optional second start from previous parameters, keeping the
    better optimum.  ``on_device=True`` routes both optimizations through
    the float32 log-space-whitened objective
    (:meth:`~.gp_models.TrainableGPModel.train`)."""
    res = gpr.train(on_device=on_device)

    if start_params is not None:
        default_params = gpr.parameters()
        try:
            gpr.set_parameters(start_params)
            res_new = gpr.train(on_device=on_device)
        except Exception:  # pragma: no cover - defensive, mirrors reference
            gpr.set_parameters(default_params)
            res_new = None

        if res_new is not None:
            both_nan = np.isnan([res.fun, res_new.fun]).all()
            if both_nan:
                msg = f"All optimizations resulted in NaN: {res}, {res_new}"
                raise ValueError(msg)
            if (res.fun < res_new.fun) or np.isnan(res_new.fun):
                gpr.set_parameters(default_params)
                # re-apply the better earlier optimum stored in default_params
            else:
                res = res_new

    return res if record_loss else None


def create_GPR(  # noqa: N802 - reference name
    state_list,
    log_scale: bool = False,
    start_params=None,
    base_kwargs=None,
    on_device: bool = False,
    rng=None,
):
    """Stack states into block-diagonal-noise GP data, build, and train.
    ``on_device=True`` trains in float32 via the log-whitened LML (see
    :func:`train_GPR`).  ``rng`` (a ``torch.Generator`` or an integer seed)
    is one stream that the states' bootstrap tables are drawn from in turn;
    None gives each state the default seed's table
    (:func:`input_GP_from_state`).

    The stages are the spans ``te.gpr.inputs`` (the states' derivatives,
    bootstraps and covariances, and the block-diagonal noise) and
    ``te.gpr.fit`` (:func:`train_GPR`)."""
    from scipy import linalg

    rng = None if rng is None else validate_rng(rng)
    with trace.span("te.gpr.inputs"):
        x_data, y_data, cov_data = [], [], []
        for s in state_list:
            if isinstance(s, ExtrapModel):
                xd, yd, cd = input_GP_from_state(s, log_scale=log_scale, rng=rng)
            else:
                xd, yd, cd = s()
            x_data.append(xd)
            y_data.append(yd)
            cov_data.append(cd)

        x_data = np.vstack(x_data)
        y_data = np.vstack(y_data)
        noise_cov = np.array([linalg.block_diag(*[cov[k] for cov in cov_data]) for k in range(y_data.shape[1])])

    gpr = create_base_GP_model((x_data, y_data, noise_cov), **(base_kwargs or {}))
    with trace.span("te.gpr.fit"):
        train_GPR(gpr, start_params=start_params, on_device=on_device)
    return gpr


# ---------------------------------------------------------------------------
# update policies
# ---------------------------------------------------------------------------


def _host_pair(a, b):
    """Two tensors of one device and dtype as numpy arrays, in one read."""
    flat = host_numpy(torch.cat([a.reshape(-1), b.reshape(-1)]))
    return flat[: a.numel()].reshape(a.shape), flat[a.numel() :].reshape(b.shape)


def _original_units(gp):
    """``(X, Y, noise cov)`` of a model in the data's own units, from its
    host copies: ``Y`` and the likelihood's covariance are stored divided by
    ``scale_fac`` and ``scale_fac**2``."""
    scale = gp._scale_np
    return gp.X, gp._y_np * scale, np.asarray(gp.likelihood.cov) * scale.reshape(-1, 1, 1) ** 2


class UpdateStopABC:
    """Shared grid/transform machinery for update + stopping classes.
    ``rng`` seeds the ``torch.Generator`` of the grid jitter (on the default
    device), where the JAX package splits a key."""

    def __init__(
        self,
        d_order_pred: int = 0,
        transform_func=identityTransform,
        log_scale: bool = False,
        avoid_repeats: bool = False,
        rng=None,
        n_grid: int = 1000,
    ) -> None:
        self.d_order_pred = d_order_pred
        self.transform_func = transform_func
        self.log_scale = log_scale
        self.avoid_repeats = avoid_repeats
        self.rng = validate_rng(rng)
        self.n_grid = int(n_grid)

    def _uniform(self, n):
        """``n`` uniform draws in [0, 1) from the generator, as numpy."""
        return host_numpy(torch.rand(n, generator=self.rng, device=self.rng.device, dtype=torch.float64))

    def create_alpha_grid(self, alpha_list):
        alpha_min, alpha_max = np.min(alpha_list), np.max(alpha_list)
        if self.log_scale:
            alpha_min, alpha_max = np.log10(alpha_min), np.log10(alpha_max)
        alpha_grid = np.linspace(alpha_min, alpha_max, self.n_grid)
        alpha_select = alpha_grid.copy()
        if self.avoid_repeats:
            jitter = 2.0 * (alpha_grid[1] - alpha_grid[0]) * (self._uniform(len(alpha_grid) - 2) - 0.5)
            alpha_select[1:-1] += jitter
            alpha_select = alpha_select[1:-1]
        return alpha_grid, alpha_select

    def get_transformed_GP_output(self, gpr, x_vals):  # noqa: N802
        """The transform of the posterior at ``x_vals`` (derivative order
        ``d_order_pred``); ``transform_func`` gets numpy, read back from the
        GPR device in one copy."""
        x_vals = np.asarray(x_vals)
        if x_vals.ndim <= 1:
            x_vals = x_vals[:, None]
        xa = np.concatenate([x_vals, self.d_order_pred * np.ones_like(x_vals)], axis=1)
        mu, var = _host_pair(*gpr.predict_f(xa))
        return self.transform_func(x_vals, mu, var)


class UpdateFuncBase(UpdateStopABC):
    """Base update policy; plotting is optional and requires matplotlib."""

    def __init__(
        self,
        show_plot: bool = False,
        save_plot: bool = False,
        save_dir="./",
        compare_func=None,
        **kws,
    ) -> None:
        super().__init__(**kws)
        self.show_plot = show_plot
        self.save_plot = save_plot
        self.save_dir = Path(save_dir)
        self.compare_func = compare_func

    def do_plotting(self, x, y, err, alpha_list) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        for k in range(y.shape[1]):
            ax.plot(x, y[:, k])
            ax.fill_between(x, err[0][:, k], err[1][:, k], alpha=0.2)
            if self.compare_func is not None:
                ax.plot(x, self.compare_func(x[:, None])[:, k], "k--")
        ax.plot(alpha_list, np.full(len(alpha_list), ax.get_ylim()[0]), "k^")
        if self.save_plot:
            n = len(list(self.save_dir.glob("GP_v_alpha*.png")))
            fig.savefig(self.save_dir / f"GP_v_alpha{n}.png")
        if self.show_plot:
            plt.show()
        plt.close(fig)

    def do_update(self, gpr, alpha_list):
        raise NotImplementedError

    def __call__(self, gpr, alpha_list):
        new_alpha, mu, std = self.do_update(gpr, alpha_list)
        if self.log_scale:
            new_alpha = 10.0**new_alpha
        return new_alpha, mu, std


class UpdateALMbrute(UpdateFuncBase):
    """Active Learning MacKay: maximize (relative) predictive uncertainty on
    a grid, with plateau-midpoint selection."""

    def do_update(self, gpr, alpha_list):
        _grid, alpha_select = self.create_alpha_grid(alpha_list)
        mu, std, conf = self.get_transformed_GP_output(gpr, alpha_select)
        if self.save_plot or self.show_plot:  # pragma: no cover
            self.do_plotting(alpha_select, mu, conf, alpha_list)

        x, y, _cov = _original_units(gpr)
        d_bool = x[:, gpr.kernel.obs_dims] == self.d_order_pred
        std_y = np.std(y[d_bool, :], axis=0)
        std_y = np.where(std_y > 0, std_y, 1.0)
        rel = std / std_y
        # grid cells tied at the peak relative uncertainty, as (row, dim)
        peak_rows, peak_dims = np.nonzero(rel == rel.max())
        # output dims vote: keep rows from the dim with the most peak cells
        rows = np.unique(peak_rows[peak_dims == np.bincount(peak_dims).argmax()])
        # a flat peak spans consecutive grid rows; pick the middle of the
        # leading run so a plateau selects its center, not its edge
        breaks = np.nonzero(np.diff(rows) != 1)[0]
        run_len = int(breaks[0]) + 1 if breaks.size else rows.size
        new_ind = rows[run_len // 2]
        return alpha_select[new_ind], mu[new_ind], std[new_ind]


class UpdateRandom(UpdateFuncBase):
    """Random grid selection."""

    def do_update(self, gpr, alpha_list):
        _grid, alpha_select = self.create_alpha_grid(alpha_list)
        mu, std, conf = self.get_transformed_GP_output(gpr, alpha_select)
        if self.save_plot or self.show_plot:  # pragma: no cover
            self.do_plotting(alpha_select, mu, conf, alpha_list)
        new_ind = min(int(self._uniform(1)[0] * alpha_select.shape[0]), alpha_select.shape[0] - 1)
        return alpha_select[new_ind], mu[new_ind], std[new_ind]


class UpdateSpaceFill(UpdateFuncBase):
    """Midpoint of the largest gap."""

    def do_update(self, gpr, alpha_list):
        _grid, alpha_select = self.create_alpha_grid(alpha_list)
        mu, std, conf = self.get_transformed_GP_output(gpr, alpha_select)
        if self.save_plot or self.show_plot:  # pragma: no cover
            self.do_plotting(alpha_select, mu, conf, alpha_list)

        sorted_alpha = np.sort(alpha_list)
        if self.log_scale:
            sorted_alpha = np.log10(sorted_alpha)
        intervals = np.diff(sorted_alpha)
        max_int_inds = np.where(np.isclose(intervals, intervals.max()))[0]
        sel = max_int_inds[min(int(self._uniform(1)[0] * len(max_int_inds)), len(max_int_inds) - 1)]
        new_alpha = sorted_alpha[sel] + 0.5 * intervals[sel]
        new_ind = np.argmin(np.abs(alpha_select - new_alpha))
        return new_alpha, mu[new_ind], std[new_ind]


class UpdateAdaptiveIntegrate(UpdateFuncBase):
    """Furthest point from existing states that stays within a relative
    uncertainty tolerance."""

    def __init__(self, tol: float = 0.005, **kws) -> None:
        super().__init__(**kws)
        self.tol = tol

    def do_update(self, gpr, alpha_list):
        _grid, alpha_select = self.create_alpha_grid(alpha_list)
        mu, std, conf = self.get_transformed_GP_output(gpr, alpha_select)
        if self.save_plot or self.show_plot:  # pragma: no cover
            self.do_plotting(alpha_select, mu, conf, alpha_list)

        rel = std / np.abs(mu)
        alpha_vals = np.array(alpha_list, dtype=float)
        if self.log_scale:
            alpha_vals = np.log10(alpha_vals)

        max_ind, max_dist = 0, -1.0
        for a_val in alpha_vals:
            close = int(np.argmin(np.abs(alpha_select - a_val)))
            if np.any(rel[close] >= self.tol):
                continue
            lo, hi = close, close
            while np.all(rel[[lo, hi], :] < self.tol):
                if lo > 0:
                    lo -= 1
                if hi < alpha_select.shape[0] - 1:
                    hi += 1
                if lo == 0 and hi == alpha_select.shape[0] - 1:
                    break
            dists = np.abs(alpha_select[[lo, hi]] - alpha_select[close])
            far = int(np.argmax(dists))
            if dists[far] > max_dist:
                max_ind, max_dist = (lo, hi)[far], dists[far]

        if max_dist == -1:
            msg = "No points used to train GP model satisfy tolerance; more simulation needed at existing points."
            raise RuntimeError(msg)

        if max_ind in {0, alpha_select.shape[0] - 1}:
            sorted_alpha = np.sort(alpha_vals)
            intervals = np.diff(sorted_alpha)
            cand = np.where(np.isclose(intervals, intervals.max()))[0]
            sel = cand[min(int(self._uniform(1)[0] * len(cand)), len(cand) - 1)]
            new_alpha = sorted_alpha[sel] + 0.5 * intervals[sel]
        else:
            new_alpha = alpha_select[max_ind]

        new_ind = np.argmin(np.abs(alpha_select - new_alpha))
        return new_alpha, mu[new_ind], std[new_ind]


class UpdateALCbrute(UpdateFuncBase):
    """EXPERIMENTAL Active Learning Cohn: minimize integrated predictive
    std after hypothetically adding each candidate.

    ``n_candidates`` limits the candidate set by striding the grid (each
    candidate is one hypothetical model); the default is 20, and
    ``n_candidates=None`` scans the full grid.  The hypothetical models
    share one structure, so every candidate is scored in one
    :func:`~.gp_models.predict_f_batched` call (``torch.func.vmap``, which
    loads ``torch._dynamo`` and so imports sympy, a dependency of torch).
    """

    def __init__(self, n_candidates: int | None = 20, **kws) -> None:
        super().__init__(**kws)
        self.n_candidates = n_candidates

    def do_update(self, gpr, alpha_list):
        from scipy import integrate

        from .gp_models import predict_f_batched

        alpha_grid, alpha_select = self.create_alpha_grid(alpha_list)
        mu, std, _conf = self.get_transformed_GP_output(gpr, alpha_select)

        # the hypothetical models are rebuilt from original-unit y, so the
        # noise is rescaled by scale_fac**2 too, or the candidate ranking
        # sees noise scale_fac**2 too small
        orig_x, orig_y, cov = _original_units(gpr)
        max_order = int(np.max(orig_x[:, gpr.kernel.obs_dims]))
        params = gpr.parameters()

        if self.n_candidates is None:
            cand = alpha_select
        else:
            cand = alpha_select[:: max(len(alpha_select) // self.n_candidates, 1)]
        grid_x = np.stack([alpha_grid, self.d_order_pred * np.ones_like(alpha_grid)], axis=1)
        this_y = np.vstack([orig_y, np.zeros((max_order + 1, orig_y.shape[1]))])
        n_new = orig_x.shape[0] + max_order + 1
        this_cov = np.zeros((cov.shape[0], n_new, n_new))
        this_cov[:, : cov.shape[1], : cov.shape[2]] = cov
        for k in range(cov.shape[0]):
            this_cov[k, cov.shape[1] :, cov.shape[2] :] = np.eye(max_order + 1) * np.mean(np.diag(cov[k]))
        models = []
        for val in cand:
            add_x = np.stack([val * np.ones(max_order + 1), np.arange(max_order + 1)], axis=1)
            model = create_base_GP_model((np.vstack([orig_x, add_x]), this_y, this_cov), kernel=gpr.kernel)
            model.set_parameters(params)
            models.append(model)

        _m, v = predict_f_batched(models, grid_x)
        new_int_std = integrate.simpson(np.sqrt(host_numpy(v)[:, :, 0]), x=alpha_grid, axis=1)

        new_ind = int(np.argmin(new_int_std))
        sel_ind = np.argmin(np.abs(alpha_select - cand[new_ind]))
        return cand[new_ind], mu[sel_ind], std[sel_ind]


# ---------------------------------------------------------------------------
# stopping metrics
# ---------------------------------------------------------------------------


class MetricBase:
    """Base stopping metric."""

    def __init__(self, name: str, tol: float) -> None:
        self.name = name
        self.tol = tol

    def _check_history(self, history) -> None:
        if history is None or len(history) != 2:
            msg = "history must be [means, stds] arrays over iterations"
            raise ValueError(msg)

    def calc_metric(self, history, x_vals, gp):
        raise NotImplementedError

    def __call__(self, history, x_vals, gp):
        self._check_history(history)
        return self.calc_metric(history, x_vals, gp)


class MaxVar(MetricBase):
    def __init__(self, tol, name="MaxVar", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)

    def calc_metric(self, history, x_vals, gp):
        return np.max(history[1][-1])


class AvgVar(MetricBase):
    def __init__(self, tol, name="AvgVar", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)

    def calc_metric(self, history, x_vals, gp):
        return np.average(history[1][-1])


class MaxRelVar(MetricBase):
    def __init__(self, tol, threshold=1e-12, name="MaxRelVar", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)
        self.threshold = threshold

    def calc_metric(self, history, x_vals, gp):
        mu = history[0][-1].copy()
        std = history[1][-1]
        mu[np.abs(mu) <= self.threshold] = self.threshold
        return np.max(std / np.abs(mu))


class AvgRelVar(MetricBase):
    def __init__(self, tol, threshold=1e-12, name="AvgRelVar", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)
        self.threshold = threshold

    def calc_metric(self, history, x_vals, gp):
        mu = history[0][-1].copy()
        std = history[1][-1]
        mu[np.abs(mu) <= self.threshold] = self.threshold
        return np.average(std / np.abs(mu))


class MaxRelGlobalVar(MetricBase, UpdateStopABC):
    def __init__(self, tol, name="MaxRelGlobalVar", **kws) -> None:
        MetricBase.__init__(self, tol=tol, name=name)
        UpdateStopABC.__init__(self, **kws)

    def calc_metric(self, history, x_vals, gp):
        std_y = np.std(history[0][-1])
        return np.max(history[1][-1] / std_y)


class MSD(MetricBase):
    def __init__(self, tol, name="MSD", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)

    def calc_metric(self, history, x_vals, gp):
        mu = history[0][-1]
        prev = history[0][-2] if history[0].shape[0] > 1 else np.zeros_like(mu)
        return np.average((mu - prev) ** 2)


class MaxAbsRelDeviation(MetricBase):
    def __init__(self, tol, threshold=1e-12, name="MaxAbsRelDev", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)
        self.threshold = threshold

    def calc_metric(self, history, x_vals, gp):
        mu = history[0][-1].copy()
        mu[np.abs(mu) <= self.threshold] = self.threshold
        if history[0].shape[0] <= 1:
            prev = np.ones_like(mu) * self.threshold
        else:
            prev = history[0][-2].copy()
            prev[np.abs(prev) <= self.threshold] = self.threshold
        return np.max(np.abs(mu - prev) / np.abs(mu))


class AvgAbsRelDeviation(MetricBase):
    def __init__(self, tol, threshold=1e-12, name="AvgAbsRelDev", **kws) -> None:
        super().__init__(tol=tol, name=name, **kws)
        self.threshold = threshold

    def calc_metric(self, history, x_vals, gp):
        mu = history[0][-1].copy()
        mu[np.abs(mu) <= self.threshold] = self.threshold
        if history[0].shape[0] <= 1:
            prev = np.ones_like(mu) * self.threshold
        else:
            prev = history[0][-2].copy()
            prev[np.abs(prev) <= self.threshold] = self.threshold
        return np.average(np.abs(mu - prev) / np.abs(mu))


class MaxAbsRelGlobalDeviation(MetricBase, UpdateStopABC):
    def __init__(self, tol, name="MaxAbsRelGlobalDeviation", **kws) -> None:
        MetricBase.__init__(self, tol=tol, name=name)
        UpdateStopABC.__init__(self, **kws)

    def calc_metric(self, history, x_vals, gp):
        std_y = np.std(history[0][-1])
        mu = history[0][-1]
        prev = history[0][-2] if history[0].shape[0] > 1 else np.zeros_like(mu)
        return np.max(np.abs(mu - prev) / std_y)


class ErrorStability(MetricBase, UpdateStopABC):
    """Ishibashi–Hino (2021) KL-divergence stopping metric with Lambert-W
    normalization.  Each model's full posterior covariance comes back from
    the GPR device in one read; the KL algebra runs in float64 numpy on the
    host."""

    def __init__(self, tol, name="ErrorStability", **kws) -> None:
        MetricBase.__init__(self, tol=tol, name=name)
        UpdateStopABC.__init__(self, **kws)
        self.r1 = None

    def calc_metric(self, history, x_vals, gp):
        from scipy import special

        input_x, input_y, input_cov = _original_units(gp)

        d_bool = input_x[:, gp.kernel.obs_dims] == self.d_order_pred
        pred_x = input_x[d_bool, :]
        if pred_x.shape[0] <= 2:
            return 1.0

        mu_curr, cov_curr = _host_pair(*gp.predict_f(pred_x, full_cov=True))
        mu_curr = self.transform_func(pred_x[:, :1], mu_curr, 1.0)[0]
        tscale = self.transform_func(pred_x[:, :1], np.ones_like(pred_x[:, :1]), 1.0)[0]
        cov_curr = cov_curr * (tscale * tscale.T)

        max_order = int(np.max(input_x[:, gp.kernel.obs_dims]))
        cut = -(max_order + 1)
        prev_input = (input_x[:cut, :], input_y[:cut, :], input_cov[:, :cut, :cut])
        prev_gp = create_base_GP_model(prev_input, kernel=gp.kernel)
        prev_gp.set_parameters(gp.parameters())
        mu_prev, cov_prev = _host_pair(*prev_gp.predict_f(pred_x, full_cov=True))
        mu_prev = self.transform_func(pred_x[:, :1], mu_prev, 1.0)[0]
        cov_prev = cov_prev * (tscale * tscale.T)

        def kl(mu_a, cov_a, mu_b, cov_b):
            """KL(b || a) summed over independent output dims."""
            inv_a = np.linalg.inv(cov_a)
            _, logdet_a = np.linalg.slogdet(cov_a)
            _, logdet_b = np.linalg.slogdet(cov_b)
            diff = (mu_a - mu_b).T[..., None]  # (D, N, 1)
            quad = np.squeeze(np.swapaxes(diff, -1, -2) @ inv_a @ diff)
            tr = np.trace(inv_a @ cov_b, axis1=-2, axis2=-1)
            return np.sum(0.5 * (tr + quad - mu_a.shape[0] + logdet_a - logdet_b))

        kl_cp = kl(mu_curr, cov_curr, mu_prev, cov_prev) + 1e-20
        kl_pc = kl(mu_prev, cov_prev, mu_curr, cov_curr) + 1e-20

        r_cp = np.exp(special.lambertw((kl_cp - 1.0) / np.e).real + 1.0) - 1.0
        r_pc = np.exp(special.lambertw((kl_pc - 1.0) / np.e).real + 1.0) - 1.0

        if self.r1 is None:
            self.r1 = r_cp + r_pc
        return (r_cp + r_pc) / self.r1


class MaxIter(MetricBase):
    """Never satisfied; forces running to max_iter."""

    def __init__(self, name="MaxIter", **kws) -> None:
        super().__init__(tol=1.0, name=name, **kws)

    def calc_metric(self, history, x_vals, gp):
        return self.tol + 1.0


class StopCriteria(UpdateStopABC):
    """All metrics must pass simultaneously; keeps a history of grid
    predictions across iterations."""

    def __init__(self, metric_funcs, **kws) -> None:
        kws["avoid_repeats"] = False
        super().__init__(**kws)
        self.metric_funcs = metric_funcs
        for m in self.metric_funcs:
            if isinstance(m, UpdateStopABC):
                m.d_order_pred = self.d_order_pred
                m.transform_func = self.transform_func
                m.log_scale = self.log_scale
                m.avoid_repeats = self.avoid_repeats
        self.history = None

    def compute_metrics(self, alpha_grid, history=None, gpr=None):
        history = self.history if history is None else history
        out, bools = {}, []
        for m in self.metric_funcs:
            val = m(history, alpha_grid, gpr)
            out[m.name] = val
            out[m.name + "_tol"] = m.tol
            bools.append(val <= m.tol)
        return bools, out

    def __call__(self, gpr, alpha_list):
        alpha_grid, _ = self.create_alpha_grid(alpha_list)
        mu, std, _conf = self.get_transformed_GP_output(gpr, alpha_grid)
        if self.history is None:
            self.history = [mu[None], std[None]]
        else:
            self.history[0] = np.concatenate([self.history[0], mu[None]], axis=0)
            self.history[1] = np.concatenate([self.history[1], std[None]], axis=0)
        bools, out = self.compute_metrics(alpha_grid, gpr=gpr)
        return np.all(bools), out


# ---------------------------------------------------------------------------
# the outer loop
# ---------------------------------------------------------------------------


def active_learning(  # noqa: C901
    init_states,
    sim_wrapper,
    update_func,
    base_dir: str = "",
    stop_criteria=None,
    max_iter: int = 10,
    alpha_name: str = "alpha",
    log_scale: bool = False,
    max_order: int = 4,
    gp_base_kwargs=None,
    num_state_repeats: int = 1,
    save_history: bool = False,
    use_predictions: bool = False,
    gp_on_device: bool = False,
):
    """Outer active-learning loop: simulate -> fit GP -> check stop ->
    acquire next point.  Returns ``(data_list, train_history)``; the losses
    in ``train_history["loss"]`` are Python floats.

    Every fit rebuilds every state and stages it through
    :func:`input_GP_from_state` (K1 and K2 on the card).  ``gp_on_device=True``
    trains each fit in float32 through the log-whitened LML (see
    :func:`train_GPR`)."""
    gp_base_kwargs = gp_base_kwargs or {}

    data_list = []
    for state in init_states:
        if isinstance(state, DataWrapper):
            data_list.append(state)
        elif isinstance(state, (int, float)):
            data_list.append(sim_wrapper.run_sim(f"{base_dir}/{alpha_name}_{state:f}", state, n_repeats=num_state_repeats))
        else:
            msg = f"cannot interpret init state {state!r}"
            raise TypeError(msg)

    alpha_list = [dat.beta for dat in data_list]
    logger.info("Initial %s values: %s", alpha_name, alpha_list)

    train_history: dict = {"loss": [], "params": []}
    if stop_criteria is not None:
        for m in stop_criteria.metric_funcs:
            train_history[m.name] = []

    this_gp = None
    for i in range(max_iter + 1):
        state_list = [dat.build_state(max_order=max_order) for dat in data_list]
        start_params = train_history["params"][-1] if i > 0 else None
        this_gp = create_GPR(
            state_list,
            log_scale=log_scale,
            base_kwargs=gp_base_kwargs,
            start_params=start_params,
            on_device=gp_on_device,
        )
        if logger.isEnabledFor(logging.INFO):
            from .gp_models import print_summary

            print_summary(this_gp)
        train_history["loss"].append(-float(host_numpy(this_gp.log_marginal_likelihood())))
        train_history["params"].append(this_gp.parameters())

        if stop_criteria is not None:
            stop_bool, stop_metrics = stop_criteria(this_gp, alpha_list)
            for m, v in stop_metrics.items():
                if "tol" not in m:
                    train_history[m].append(v)
            if stop_bool:
                logger.info("Stopping criteria satisfied: %s", stop_metrics)
                break
            logger.info("Current stopping metrics: %s", stop_metrics)

        if i == max_iter:
            logger.info("Reached maximum iterations (%s)", max_iter)
            break

        new_alpha, new_mu, new_std = update_func(this_gp, alpha_list)
        extra = {"model_pred": new_mu, "model_std": new_std} if use_predictions else {}
        this_data = sim_wrapper.run_sim(
            f"{base_dir}/{alpha_name}_{new_alpha:f}",
            new_alpha,
            n_repeats=num_state_repeats,
            **extra,
        )

        if np.any(np.isclose(alpha_list, new_alpha)):
            replace_ind = int(np.where(np.isclose(alpha_list, new_alpha))[0][0])
            data_list[replace_ind] = this_data
        else:
            data_list.append(this_data)
            alpha_list.append(new_alpha)
        logger.info("After %s updates, %s values: %s", i + 1, alpha_name, alpha_list)

    if save_history and stop_criteria is not None:
        # the JAX package's layout: pred_mu / pred_std / alpha and every
        # train_history entry; the parameter dicts as a (iter, n_params)
        # array and a name list, so the file round-trips without pickling
        hist_arrays = {}
        for k, v in train_history.items():
            if k == "params":
                names = sorted(v[0]) if v else []
                hist_arrays["param_names"] = np.array(names)
                hist_arrays["params"] = np.array([[it[nm] for nm in names] for it in v], dtype=np.float64)
            else:
                hist_arrays[k] = np.array(v)
        np.savez(
            f"{base_dir}/active_history.npz",
            pred_mu=stop_criteria.history[0],
            pred_std=stop_criteria.history[1],
            alpha=np.array(alpha_list),
            **hist_arrays,
        )

    return data_list, train_history


def load_active_history(path):
    """Load an ``active_history.npz`` written by :func:`active_learning` (of
    either package).

    Returns the saved dict with ``params`` reconstructed as a list of
    ``{name: value}`` dicts, so ``out["params"][-1]`` can be passed as
    ``create_GPR(..., start_params=...)`` to warm-restart a run.
    """
    with np.load(path, allow_pickle=False) as f:
        out = {k: f[k] for k in f.files}
    if "params" in out and "param_names" in out:
        names = [str(n) for n in out.pop("param_names")]
        out["params"] = [dict(zip(names, row)) for row in np.asarray(out["params"], dtype=np.float64)]
    return out

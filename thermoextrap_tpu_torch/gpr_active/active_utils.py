r"""GP staging, simulation wrappers and the GPR builders (counterpart of the
first half of ``thermoextrap_tpu/gpr_active/active_utils.py``).

- GP input assembly from extrapolation states: each state's derivatives
  and its bootstrap replicates run on the state's device (K1 for the
  reduction, K2 for the count-table bootstrap on the card) and are read
  back once each, as numpy; the bootstrap covariance is ``np.cov`` on the
  host;
- ``DataWrapper`` / ``SimWrapper`` — host-side file and process plumbing
  around simulations;
- ``create_base_GP_model``, ``train_GPR`` and ``create_GPR``.

The active-learning half of the JAX module (update policies, stopping
metrics, ``StopCriteria`` and the ``active_learning`` loop) is not ported
yet; it is ROADMAP Queue 1 item 3's second part, and its names raise an
``ImportError`` that says so.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from ..models.extrap import ExtrapModel
from ..utils.device import host_numpy
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

__all__ = [
    "ChangeInnerOuterRBFDerivKernel",
    "DataWrapper",
    "RBFDerivKernel",
    "SimWrapper",
    "create_GPR",
    "create_base_GP_model",
    "get_logweights",
    "identityTransform",
    "input_GP_from_state",
    "make_matern_expr",
    "make_poly_expr",
    "make_rbf_expr",
    "train_GPR",
]

# the JAX module's names that come with the active-learning half
_NOT_PORTED = (
    "AvgAbsRelDeviation",
    "AvgRelVar",
    "AvgVar",
    "ErrorStability",
    "MSD",
    "MaxAbsRelDeviation",
    "MaxAbsRelGlobalDeviation",
    "MaxIter",
    "MaxRelGlobalVar",
    "MaxRelVar",
    "MaxVar",
    "MetricBase",
    "StopCriteria",
    "UpdateALCbrute",
    "UpdateALMbrute",
    "UpdateAdaptiveIntegrate",
    "UpdateFuncBase",
    "UpdateRandom",
    "UpdateSpaceFill",
    "UpdateStopABC",
    "active_learning",
    "load_active_history",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        msg = (
            f"{__name__}.{name} is not ported yet: it comes with the "
            "active-learning half of ROADMAP Queue 1 item 3"
        )
        raise ImportError(msg)
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)


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


def input_GP_from_state(state: ExtrapModel, n_rep: int = 100, log_scale: bool = False):  # noqa: N802
    """Assemble GP input (X, Y, per-dim bootstrap covariance) from an
    extrapolation state, as numpy float64.

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
        boot = host_numpy(state.resample({"nrep": n_rep}).derivs())
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
):
    """Stack states into block-diagonal-noise GP data, build, and train.
    ``on_device=True`` trains in float32 via the log-whitened LML (see
    :func:`train_GPR`)."""
    from scipy import linalg

    x_data, y_data, cov_data = [], [], []
    for s in state_list:
        if isinstance(s, ExtrapModel):
            xd, yd, cd = input_GP_from_state(s, log_scale=log_scale)
        else:
            xd, yd, cd = s()
        x_data.append(xd)
        y_data.append(yd)
        cov_data.append(cd)

    x_data = np.vstack(x_data)
    y_data = np.vstack(y_data)
    noise_cov = np.array([linalg.block_diag(*[cov[k] for cov in cov_data]) for k in range(y_data.shape[1])])

    gpr = create_base_GP_model((x_data, y_data, noise_cov), **(base_kwargs or {}))
    train_GPR(gpr, start_params=start_params, on_device=on_device)
    return gpr

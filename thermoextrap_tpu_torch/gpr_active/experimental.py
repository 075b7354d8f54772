r"""Experimental noise-GP GPR variants (Binois/Ankenman protocol), counterpart
of ``thermoextrap_tpu/gpr_active/experimental.py``:

- :class:`HetGaussianNoiseGP` — a heteroscedastic Gaussian likelihood whose
  noise field is itself modeled by an inner GP on the *logarithm* of the
  noise variance;
- :class:`FullyHeteroscedasticGPR` — an exact GPR whose noise diagonal is
  the inner GP's posterior prediction, with the outer and inner
  log-likelihoods optimized JOINTLY (Binois et al. 2018, over the per-state
  means protocol of Ankenman et al. 2010).

The inner noise GP is a compact exact GPR (:class:`PlainGPR`) over
closed-form stationary kernels (:class:`StationaryKernel`: RBF / Matérn
5/2, per-dimension lengthscales).  Everything is plain torch in float64 on
:func:`..utils.compute.compute_device`; the joint negative LML and its
gradient over the concatenated unconstrained vector are one autograd pass
(:func:`.gp_models._value_and_grad`), driven by the shared scipy L-BFGS-B
loop of :class:`~.gp_models.TrainableGPModel` with one host read an
evaluation.  The built functions are cached at module level on the model
structure, as :mod:`.gp_models` caches its cores.

The noise observation of :meth:`FullyHeteroscedasticGPR.predict_log_density`
is reconstructed explicitly (``var * n``), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.compute import compute_device
from .gp_models import (
    Parameter,
    TrainableGPModel,
    _cholesky,
    _f64,
    _softplus,
    _solve_lower,
    _value_and_grad,
)

__all__ = [
    "FullyHeteroscedasticGPR",
    "HetGaussianNoiseGP",
    "PlainGPR",
    "StationaryKernel",
]

_JITTER = 1.0e-10
_LOG_2PI = math.log(2.0 * math.pi)


def _gaussian_log_density(x, mu, var):
    """Elementwise N(x | mu, var) log density."""
    return -0.5 * (_LOG_2PI + torch.log(var) + (x - mu) ** 2 / var)


def _mvn_log_density(y, mu, chol):
    """Multivariate-normal log density summed over output columns of ``y``
    with a single shared Cholesky factor ``chol`` (N, N)."""
    a = _solve_lower(chol, y - mu)
    n, d = y.shape
    return -0.5 * torch.sum(a**2) - 0.5 * n * d * _LOG_2PI - d * torch.sum(torch.log(torch.diagonal(chol)))


# ---------------------------------------------------------------------------
# stationary kernels in closed form
# ---------------------------------------------------------------------------


def _sqdist(x1, x2, ls):
    """Scaled squared distance matrix: ``sum_k ((x1 - x2) / ls)^2``."""
    s1 = x1 / ls
    s2 = x2 / ls
    return torch.clamp(torch.sum(s1**2, -1)[:, None] - 2.0 * s1 @ s2.T + torch.sum(s2**2, -1)[None, :], min=0.0)


class StationaryKernel:
    """Closed-form stationary kernel with per-dimension lengthscales, for
    inputs without derivative columns.  ``kind``:

    - ``"rbf"``:      ``variance * exp(-r2 / 2)``
    - ``"matern52"``: ``variance * (1 + sqrt(5) r + 5 r2 / 3) exp(-sqrt(5) r)``

    with ``r2`` the lengthscale-scaled squared distance.  Parameters are
    ``variance`` and ``ls{k}`` for each input dimension, all positive.
    """

    KINDS = ("rbf", "matern52")

    def __init__(self, n_dims: int = 1, kind: str = "matern52", variance: float = 1.0, lengthscales=None) -> None:
        if kind not in self.KINDS:
            msg = f"kind must be one of {self.KINDS}, got {kind!r}"
            raise ValueError(msg)
        self.kind = kind
        self.n_dims = int(n_dims)
        if lengthscales is None:
            lengthscales = np.ones(self.n_dims)
        lengthscales = np.broadcast_to(np.asarray(lengthscales, dtype=np.float64), (self.n_dims,))
        self.params = {"variance": Parameter(float(variance), "positive")}
        for k in range(self.n_dims):
            self.params[f"ls{k}"] = Parameter(float(lengthscales[k]), "positive")

    @property
    def param_names(self):
        return ("variance", *(f"ls{k}" for k in range(self.n_dims)))

    def kernel_fn(self):
        """Pure ``(x1, x2, pvals) -> K`` closure; ``pvals`` ordered as
        :attr:`param_names`."""
        kind = self.kind

        def kfun(x1, x2, pvals):
            variance = pvals[0]
            ls = torch.stack(list(pvals[1:]))
            r2 = _sqdist(x1, x2, ls)
            if kind == "rbf":
                return variance * torch.exp(-0.5 * r2)
            r = torch.sqrt(r2 + 1e-36)
            sq5 = math.sqrt(5.0)
            return variance * (1.0 + sq5 * r + (5.0 / 3.0) * r2) * torch.exp(-sq5 * r)

        return kfun

    def _pvals(self, device):
        return [_f64(self.params[k].value, device) for k in self.param_names]

    def __call__(self, X, X2=None):
        """The kernel matrix at the current parameter values: a float64
        tensor on the GPR device."""
        device = compute_device()
        X = _f64(X, device)
        X2 = X if X2 is None else _f64(X2, device)
        return self.kernel_fn()(X, X2, self._pvals(device))


# ---------------------------------------------------------------------------
# plain exact GPR (the inner noise model)
# ---------------------------------------------------------------------------

_EXP_CORE: dict = {}


def _build_split(spec_struct):
    """``(trainable_vec, fixed_vec) -> {name: constrained value}`` for a
    static (name, transform, trainable) layout."""

    def split(vec, fixed):
        out = {}
        ti = fi = 0
        for name, transform, trainable in spec_struct:
            if trainable:
                out[name] = _softplus(vec[ti]) if transform == "positive" else vec[ti]
                ti += 1
            else:
                out[name] = fixed[fi]
                fi += 1
        return out

    return split


def _gpr_chol(kfun, pvals, sigma2, x):
    k = kfun(x, x, pvals)
    eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return _cholesky(k + (sigma2 + _JITTER) * eye)


def _gpr_predict(kfun, pvals, sigma2, x, y, xnew, full_cov):
    """Latent posterior (mean, var) of an exact zero-mean GPR — the
    ``gpflow.models.GPR.predict_f`` math."""
    chol = _gpr_chol(kfun, pvals, sigma2, x)
    kmn = kfun(x, xnew, pvals)
    a = _solve_lower(chol, kmn)
    b = _solve_lower(chol, y)
    mean = a.T @ b
    if full_cov:
        var = kfun(xnew, xnew, pvals) - a.T @ a
    else:
        var = (torch.diagonal(kfun(xnew, xnew, pvals)) - torch.sum(a**2, dim=0))[:, None] * torch.ones_like(mean)
    return mean, var


def _build_plain_gpr_fns(kernel, spec_struct):
    split = _build_split(spec_struct)
    kfun = kernel.kernel_fn()
    knames = [f"kernel/{k}" for k in kernel.param_names]

    def lml(vec, fixed, x, y):
        p = split(vec, fixed)
        chol = _gpr_chol(kfun, [p[k] for k in knames], p["likelihood/variance"], x)
        return _mvn_log_density(y, 0.0, chol)

    def neg(*args):
        return -lml(*args)

    def predict(vec, fixed, x, y, xnew, full_cov):
        p = split(vec, fixed)
        return _gpr_predict(kfun, [p[k] for k in knames], p["likelihood/variance"], x, y, xnew, full_cov)

    return {"lml": lml, "neg_vag": _value_and_grad(neg), "predict": predict}


class PlainGPR(TrainableGPModel):
    """Exact zero-mean GPR with iid Gaussian noise — the
    ``gpflow.models.GPR`` role for the inner noise model of
    :class:`HetGaussianNoiseGP`.

    ``data = (X (N, D), Y (N, 1))``; kernel a :class:`StationaryKernel`.
    The data stay on the host in float64 and go to the GPR device at each
    call.
    """

    def __init__(self, data, kernel: StationaryKernel, noise_variance: float = 1.0) -> None:
        X, Y = data
        self.X = np.asarray(X, dtype=np.float64)
        self.Y = np.asarray(Y, dtype=np.float64).reshape(self.X.shape[0], -1)
        self.kernel = kernel
        self.likelihood_variance = Parameter(float(noise_variance), "positive")

    def _param_specs(self):
        specs = {f"kernel/{k}": p for k, p in self.kernel.params.items()}
        specs["likelihood/variance"] = self.likelihood_variance
        return specs

    def _structure_key(self):
        return ("plain_gpr", self.kernel.kind, self.kernel.n_dims, self._spec_struct())

    def _lml_fns(self):
        key = self._structure_key()
        if key not in _EXP_CORE:
            _EXP_CORE[key] = _build_plain_gpr_fns(self.kernel, self._spec_struct())
        return _EXP_CORE[key]

    def _bound_args(self):
        device = compute_device()
        return (_f64(self._fixed_constrained(), device), _f64(self.X, device), _f64(self.Y, device))

    def predict_f(self, Xnew, full_cov: bool = False):
        """Latent posterior at new inputs: float64 tensors on the GPR device."""
        device = compute_device()
        return self._lml_fns()["predict"](
            _f64(self.get_unconstrained(), device), *self._bound_args(), _f64(Xnew, device), bool(full_cov)
        )


# ---------------------------------------------------------------------------
# the noise-GP likelihood
# ---------------------------------------------------------------------------


class HetGaussianNoiseGP:
    """Heteroscedastic Gaussian likelihood whose noise field is an inner GP.

    The latent ``F`` has two columns — ``[mean, noise variance]`` — and the
    observation ``Y`` two columns — ``[value, noise-variance observation]``.
    The log probability adds (a) the Gaussian density of the value given the
    mean/noise columns and (b) the Gaussian density of the *log* noise
    observation around the *log* predicted noise under the inner GP's own
    likelihood variance.  ``data = (X, log_noise_obs)`` seeds the inner GP.
    Inputs may be numpy or tensors; outputs are float64 tensors on the GPR
    device.
    """

    def __init__(self, data, noise_kernel: StationaryKernel | None = None) -> None:
        X, Z = data
        X = np.asarray(X, dtype=np.float64)
        if noise_kernel is None:
            noise_kernel = StationaryKernel(X.shape[1], "matern52")
        self.noise_gp = PlainGPR((X, Z), noise_kernel)

    @property
    def _lik_var(self):
        return _f64(self.noise_gp.likelihood_variance.value)

    def scalar_log_prob(self, F, Y):
        """Per-row log p(Y | F)."""
        F, Y = _f64(F), _f64(Y)
        return _gaussian_log_density(Y[:, :1], F[:, :1], F[:, 1:]) + _gaussian_log_density(
            torch.log(Y[:, 1:]), torch.log(F[:, 1:]), self._lik_var
        )

    def conditional_mean(self, F):
        return _f64(F)[:, :1]

    def conditional_variance(self, F):
        return _f64(F)[:, 1:]

    def predict_mean_and_var(self, Fmu, Fvar):
        """Observation mean/variance given latent ``[mean, noise]`` columns:
        the noise prediction adds straight onto the latent variance."""
        Fmu, Fvar = _f64(Fmu), _f64(Fvar)
        return Fmu[:, :1], Fvar[:, :1] + Fmu[:, 1:]

    def predict_log_density(self, Fmu, Fvar, Y):
        """Log density of ``Y = [value, noise obs]`` under the predictive
        (external) and latent log-noise (inner-GP) Gaussians."""
        Fmu, Fvar, Y = _f64(Fmu), _f64(Fvar), _f64(Y)
        external = torch.sum(_gaussian_log_density(Y[:, :1], Fmu[:, :1], Fvar[:, :1] + Fmu[:, 1:]), dim=-1)
        latent = torch.sum(_gaussian_log_density(torch.log(Y[:, 1:]), torch.log(Fmu[:, 1:]), Fvar[:, 1:]), dim=-1)
        return external + latent

    def variational_expectations(self, Fmu, Fvar, Y):
        """E_q[log p(Y | F)] under a factorized Gaussian q(F) (the noise
        column enters through its mean, as in the reference)."""
        Fmu, Fvar, Y = _f64(Fmu), _f64(Fvar), _f64(Y)
        lik_var = self._lik_var
        external = torch.sum(
            -0.5 * _LOG_2PI - 0.5 * torch.log(Fmu[:, 1:]) - 0.5 * ((Y[:, :1] - Fmu[:, :1]) ** 2 + Fvar[:, :1]) / Fmu[:, 1:],
            dim=-1,
        )
        latent = torch.sum(
            -0.5 * _LOG_2PI
            - 0.5 * torch.log(lik_var)
            - 0.5 * ((Y[:, 1:] - torch.log(Fmu[:, 1:])) ** 2 + Fvar[:, 1:]) / lik_var,
            dim=-1,
        )
        return external + latent


# ---------------------------------------------------------------------------
# the fully heteroscedastic model
# ---------------------------------------------------------------------------


def _build_joint_fns(kernel, noise_kernel, spec_struct):
    split = _build_split(spec_struct)
    kfun = kernel.kernel_fn()
    nfun = noise_kernel.kernel_fn()
    knames = [f"kernel/{k}" for k in kernel.param_names]
    nnames = [f"noise_kernel/{k}" for k in noise_kernel.param_names]

    def _parts(p, x, z, n):
        """Inner-GP Cholesky + the outer noise diagonal it predicts."""
        chol_n = _gpr_chol(nfun, [p[k] for k in nnames], p["noise_lik/variance"], x)
        # inner posterior mean of log noise AT the training points
        log_s = nfun(x, x, [p[k] for k in nnames]) @ torch.cholesky_solve(z, chol_n)
        return chol_n, torch.exp(log_s[:, 0]) / n

    def _outer_chol(p, x, s_diag):
        k = kfun(x, x, [p[k] for k in knames])
        return _cholesky(k + torch.diag(s_diag + _JITTER))

    def lml(vec, fixed, x, y, z, n, mean_x):
        p = split(vec, fixed)
        chol_n, s_diag = _parts(p, x, z, n)
        chol = _outer_chol(p, x, s_diag)
        return _mvn_log_density(y, mean_x, chol) + _mvn_log_density(z, 0.0, chol_n)

    def neg(*args):
        return -lml(*args)

    def predict(vec, fixed, x, y, z, n, mean_x, xnew, mean_new, full_cov):
        p = split(vec, fixed)
        _, s_diag = _parts(p, x, z, n)
        chol = _outer_chol(p, x, s_diag)
        po = [p[k] for k in knames]
        a = _solve_lower(chol, kfun(x, xnew, po))
        b = _solve_lower(chol, y - mean_x)
        f_mean = a.T @ b + mean_new
        if full_cov:
            f_var = kfun(xnew, xnew, po) - a.T @ a
        else:
            f_var = (torch.diagonal(kfun(xnew, xnew, po)) - torch.sum(a**2, dim=0))[:, None] * torch.ones_like(f_mean)
        return f_mean, f_var

    def predict_noise(vec, fixed, x, z, xnew):
        p = split(vec, fixed)
        return _gpr_predict(nfun, [p[k] for k in nnames], p["noise_lik/variance"], x, z, xnew, False)

    return {"lml": lml, "neg_vag": _value_and_grad(neg), "predict": predict, "predict_noise": predict_noise}


class FullyHeteroscedasticGPR(TrainableGPModel):
    """Exact GPR whose noise diagonal is predicted by an inner noise GP,
    trained by the JOINT log likelihood (Binois et al. 2018 / Ankenman et
    al. 2010).

    ``data = (X (N, D), Y (N, 3))`` with ``Y`` columns ``[value,
    variance-of-mean, n_samples]``.  The inner GP regresses
    ``log(variance * n)`` (the per-configuration noise); the outer model
    sees ``exp(prediction) / n`` on its diagonal, so states estimated from
    more samples get proportionally less noise.  The two marginal
    likelihoods are summed and optimized together over the concatenated
    parameter vector (outer kernel + inner kernel + inner likelihood
    variance) by the shared NaN-guarded L-BFGS loop.

    ``mean_function`` must be a FIXED callable (numpy or tensor out): it is
    evaluated on the training inputs once at construction and its
    parameters are not part of the trained vector.
    """

    def __init__(self, data, kernel: StationaryKernel, mean_function=None, noise_kernel: StationaryKernel | None = None) -> None:
        X, Y = data
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        if Y.ndim != 2 or Y.shape[1] != 3:
            msg = f"Y must be (N, 3) = [value, variance, n_samples], got {Y.shape}"
            raise ValueError(msg)
        self.X = X
        self.Y = Y
        self.kernel = kernel
        self.mean_function = mean_function
        self.likelihood = HetGaussianNoiseGP((X, np.log(Y[:, 1:2] * Y[:, 2:3])), noise_kernel)
        # conservative per-state sample count for predict_y at new points
        self.min_samps = float(np.min(Y[:, -1]))
        self._mean_x = self._mean(X, torch.device("cpu"))

    # -- structure/plumbing -----------------------------------------------------

    def _mean(self, X, device=None):
        n = np.shape(X)[0]
        if self.mean_function is None:
            return torch.zeros((n, 1), dtype=torch.float64, device=compute_device() if device is None else device)
        return _f64(self.mean_function(X), device).reshape(n, 1)

    def _param_specs(self):
        specs = {f"kernel/{k}": p for k, p in self.kernel.params.items()}
        specs.update({f"noise_kernel/{k}": p for k, p in self.likelihood.noise_gp.kernel.params.items()})
        specs["noise_lik/variance"] = self.likelihood.noise_gp.likelihood_variance
        return specs

    def _structure_key(self):
        return (
            "fully_het_gpr",
            self.kernel.kind,
            self.kernel.n_dims,
            self.likelihood.noise_gp.kernel.kind,
            self._spec_struct(),
        )

    def _lml_fns(self):
        key = self._structure_key()
        if key not in _EXP_CORE:
            _EXP_CORE[key] = _build_joint_fns(self.kernel, self.likelihood.noise_gp.kernel, self._spec_struct())
        return _EXP_CORE[key]

    def _bound_args(self):
        device = compute_device()
        return (
            _f64(self._fixed_constrained(), device),
            _f64(self.X, device),
            _f64(self.Y[:, :1], device),
            _f64(self.likelihood.noise_gp.Y, device),
            _f64(self.Y[:, -1], device),
            _f64(self._mean_x, device),
        )

    # -- prediction -------------------------------------------------------------

    def maximum_log_likelihood_objective(self):
        return self.log_marginal_likelihood()

    def predict_noise(self, Xnew):
        """(noise variance, latent log-noise variance) at new inputs —
        ``exp`` of the inner GP's posterior mean.  This is the
        *per-configuration* noise; divide by a sample count for the noise of
        an n-sample mean."""
        device = compute_device()
        fixed, x, _y, z, _n, _m = self._bound_args()
        log_noise, log_noise_var = self._lml_fns()["predict_noise"](
            _f64(self.get_unconstrained(), device), fixed, x, z, _f64(Xnew, device)
        )
        return torch.exp(log_noise), log_noise_var

    def predict_f(self, Xnew, full_cov: bool = False):
        """Latent posterior at new inputs under the noise-GP-predicted
        training noise diagonal: float64 tensors on the GPR device."""
        device = compute_device()
        return self._lml_fns()["predict"](
            _f64(self.get_unconstrained(), device),
            *self._bound_args(),
            _f64(Xnew, device),
            self._mean(Xnew),
            bool(full_cov),
        )

    def predict_y(self, Xnew):
        """Observation mean/variance at new inputs, with new-point noise
        taken conservatively at the SMALLEST training sample count."""
        f_mean, f_var = self.predict_f(Xnew)
        noise_mean, noise_var = self.predict_noise(Xnew)
        noise_mean = noise_mean / self.min_samps
        return self.likelihood.predict_mean_and_var(
            torch.cat([f_mean, noise_mean], dim=1), torch.cat([f_var, noise_var], dim=1)
        )

    def predict_log_density(self, data):
        """Per-point log density of held-out ``(X, Y)`` with ``Y`` in the
        training 3-column layout (the noise observation is ``var * n``,
        matching the inner GP's training target)."""
        X, Y = data
        Y = np.asarray(Y, dtype=np.float64)
        if Y.ndim != 2 or Y.shape[1] != 3:
            msg = f"Y must be (N, 3) = [value, variance, n_samples], got {Y.shape}"
            raise ValueError(msg)
        f_mean, f_var = self.predict_f(X)
        noise_mean, noise_var = self.predict_noise(X)
        return self.likelihood.predict_log_density(
            torch.cat([f_mean, noise_mean], dim=1),
            torch.cat([f_var, noise_var], dim=1),
            np.stack([Y[:, 0], Y[:, 1] * Y[:, 2]], axis=1),
        )

r"""Derivative-informed heteroscedastic Gaussian-process regression in torch.

Counterpart of ``thermoextrap_tpu/gpr_active/gp_models.py``:

- **Kernels** are derivative kernels over rows ``[locations, derivative
  orders]``.  A sympy expression is differentiated once per order pair and
  lambdified to torch (sympy is imported on first use, never at module
  top); :mod:`.kernels` adds the kernels that are not sympy expressions:
  the 1-D RBF in closed (Hermite) form, and kernels over a torch callable
  differentiated by nested ``torch.func.grad``.
- **The core** (the LML, its log-whitened form, their value and gradient,
  and the posterior) is plain torch in float64 on
  :func:`..utils.compute.compute_device`: the card when there is one, the
  CPU inside :func:`..utils.compute.host_f64`.  Gradients come from
  autograd.  There is nothing to compile, so the module-level cache of the
  JAX package's compiled cores (``_COMPILED_CORE``) holds the built
  functions and their derivative-function tables, keyed on the same
  structure.
- **The Cholesky guard**: ``torch.linalg.cholesky`` raises on a matrix that
  is not positive definite, where ``jnp.linalg.cholesky`` returns NaN and
  the training loop's rule depends on that (a non-finite objective gives
  ``1e12`` and a zero gradient).  The core factors with
  ``torch.linalg.cholesky_ex`` and makes the factor NaN where ``info != 0``,
  on the device, with no host read.
- **Training** is scipy's L-BFGS-B on the host over the few unconstrained
  parameters, as in the reference; each evaluation runs the objective and
  its gradient on the GPR device and reads both back in one copy.  The
  counter ``gpr_lml_evals`` (:data:`GPR_LML_EVALS`, held in
  :data:`..utils.trace.COUNTERS`) gains one an evaluation.
- The positive transform is ``logaddexp(x, 0) + 1e-6``
  (``torch.nn.functional.softplus`` switches to the identity above 20 and
  would differ).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils import trace
from ..utils.compute import compute_device
from ..utils.device import host_numpy

__all__ = [
    "ConstantMeanWithDerivs",
    "DerivativeKernel",
    "HetGaussianDeriv",
    "HetGaussianSimple",
    "HeteroscedasticGPR",
    "HeteroscedasticGPRAnalyticalScale",
    "LinearWithDerivs",
    "Parameter",
    "SympyMeanFunc",
    "TrainableGPModel",
    "print_summary",
    "multioutput_multivariate_normal",
]

_F64 = torch.float64
# objective-and-gradient evaluations of TrainableGPModel.train, the start and
# final ones included
GPR_LML_EVALS = trace.register("gpr_lml_evals", {"n": 0})
_SOFTPLUS_SHIFT = 1e-6  # gpflow positive() lower bound
_NO_SYMPY = (
    "sympy is not installed, and this kernel or mean function is a sympy "
    "expression; RBFDerivKernel, ChangeInnerOuterRBFDerivKernel and "
    "CallableDerivativeKernel (thermoextrap_tpu_torch.gpr_active.kernels) "
    "are not sympy expressions (the default RBFDerivKernel needs no sympy at all)"
)


def _import_sympy():
    try:
        import sympy
    except ImportError as err:
        raise ImportError(_NO_SYMPY) from err
    return sympy


def _f64(a, device=None):
    """A float64 tensor on ``device`` (the GPR device when None)."""
    device = compute_device() if device is None else device
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_F64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x)) + _SOFTPLUS_SHIFT


def _inv_softplus(y):
    y = torch.clamp(y - _SOFTPLUS_SHIFT, min=1e-12)
    # stable for large y: softplus(x) ~ x, so inverse ~ y
    return torch.where(y > 30.0, y, torch.log(torch.expm1(torch.clamp(y, max=30.0))))


@dataclass
class Parameter:
    """Trainable scalar with an optional positivity transform."""

    value: float
    transform: str = "none"  # "none" | "positive"
    trainable: bool = True

    def constrain(self, raw):
        return _softplus(raw) if self.transform == "positive" else raw

    def unconstrain(self):
        """The unconstrained value, a float64 CPU tensor."""
        v = torch.tensor(float(self.value), dtype=_F64)
        return _inv_softplus(v) if self.transform == "positive" else v


# ---------------------------------------------------------------------------
# derivative kernel
# ---------------------------------------------------------------------------


def _group_order_rows(d):
    """Group integer derivative-order rows: ``(unique order tuples, (N,)
    group-id array)``.  The unique tuples are static structure (they select
    which derivative functions participate); the ids are data."""
    d = np.asarray(d)
    uniq, gid = np.unique(d, axis=0, return_inverse=True)
    groups = tuple(tuple(int(v) for v in row) for row in uniq)
    return groups, np.asarray(gid, dtype=np.int64).reshape(-1)


def _full(vals, shape, like):
    """A pair function's value as a tensor of ``shape`` (a derivative that is
    constant in the locations lambdifies to a number or a 0-d tensor).  A
    number is filled on ``like``'s device, not copied from the host, so that
    a CUDA graph of the objective (:func:`_graphed_objective`) can capture
    it."""
    if not isinstance(vals, torch.Tensor):
        return torch.full(shape, float(vals), dtype=like.dtype, device=like.device)
    return torch.broadcast_to(vals, shape)


def _pair_masked_matrix(x1, gid1, groups1, x2, gid2, groups2, pvals, fns):
    """K[i, j] = fns[(g1_i, g2_j)](x1_i, x2_j, params) by masked passes over
    the unique order-pair table (the JAX package's static mask-sum)."""
    n1, n2 = x1.shape[0], x2.shape[0]
    obs = x1.shape[1]
    g1 = [x1[:, k : k + 1].expand(n1, n2) for k in range(obs)]
    g2 = [x2[:, k : k + 1].T.expand(n1, n2) for k in range(obs)]
    out = torch.zeros((n1, n2), dtype=x1.dtype, device=x1.device)
    for ia, a in enumerate(groups1):
        for ib, b in enumerate(groups2):
            vals = _full(fns[a, b](*g1, *g2, *pvals), (n1, n2), out)
            mask = (gid1[:, None] == ia) & (gid2[None, :] == ib)
            out = torch.where(mask, vals, out)
    return out


def _pair_masked_diag(x, gid, groups, pvals, fns):
    """diag(K) companion of :func:`_pair_masked_matrix`."""
    n = x.shape[0]
    cols = [x[:, k] for k in range(x.shape[1])]
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for ia, a in enumerate(groups):
        vals = _full(fns[a, a](*cols, *cols, *pvals), (n,), out)
        out = torch.where(gid == ia, vals, out)
    return out


class DerivativeKernel:
    """Kernel over derivative-augmented inputs, built from a sympy expression.

    Input rows are ``[locations (obs_dims), derivative orders (obs_dims)]``.
    ``K[i, j] = d^{d_i} d^{d_j} k(x_i, x_j)`` with the mixed partial taken
    symbolically once per unique order pair and lambdified to torch.  sympy
    is imported here, on first use; without it the constructor raises an
    ``ImportError`` naming the kernels that need none.

    Parameters
    ----------
    kernel_expr :
        sympy expression in symbols ``x1``/``x2`` (or ``x1_0``... for
        multi-dim) plus named parameter symbols.
    obs_dims :
        Input dimensionality (inputs have ``2 * obs_dims`` columns).
    kernel_params :
        ``{name: value}`` or ``{name: Parameter}``; defaults to 1.0 positive
        parameters mined from the expression.

    Subclasses that are not a sympy expression set ``params`` and
    ``obs_dims`` themselves and override :meth:`structure_id` and
    :meth:`_deriv_fn` (and may override :meth:`_pair_matrix` /
    :meth:`_pair_diag` with a whole-matrix form).
    """

    def __init__(self, kernel_expr, obs_dims: int = 1, kernel_params=None) -> None:
        _import_sympy()
        self.kernel_expr = kernel_expr
        self.obs_dims = int(obs_dims)

        x_syms, param_syms = [], []
        for s in kernel_expr.free_symbols:
            if "x1" in s.name.casefold() or "x2" in s.name.casefold():
                x_syms.append(s)
            else:
                param_syms.append(s)
        x_syms.sort(key=lambda s: s.name)
        param_syms.sort(key=lambda s: s.name)
        if len(x_syms) != 2 * self.obs_dims:
            msg = f"kernel expression symbols {x_syms} do not match 2*obs_dims={2 * obs_dims}"
            raise ValueError(msg)
        if not param_syms:
            msg = "kernel expression has no optimizable parameters"
            raise ValueError(msg)
        self.x_syms = x_syms
        self.param_syms = param_syms
        self.params: dict[str, Parameter] = _make_params({s.name: (kernel_params or {}).get(s.name, 1.0) for s in param_syms})
        self._fn_cache: dict[tuple, Callable] = {}

    def structure_id(self):
        """Hashable identity of the kernel's FUNCTIONAL FORM, used in the
        core cache keys (parameter values excluded — they are arguments).
        Kernels whose form is not a sympy expression override this."""
        if getattr(self, "_srepr", None) is None:
            self._srepr = _import_sympy().srepr(self.kernel_expr)
        return self._srepr

    # -- derivative function table --------------------------------------------

    # module-level cache so fresh kernel instances with the same expression
    # (e.g. one per active-learning iteration) share lambdified derivative
    # functions AND therefore the core caches downstream
    _global_fn_cache: dict = {}

    def _deriv_fn(self, d1: tuple, d2: tuple) -> Callable:
        key = (tuple(d1), tuple(d2))
        if key not in self._fn_cache:
            gkey = (self.structure_id(), key)
            if gkey not in DerivativeKernel._global_fn_cache:
                sp = _import_sympy()
                expr = sp.diff(
                    self.kernel_expr,
                    *zip(self.x_syms[: self.obs_dims], d1),
                    *zip(self.x_syms[self.obs_dims :], d2),
                )
                DerivativeKernel._global_fn_cache[gkey] = sp.lambdify(
                    (*self.x_syms, *self.param_syms), expr, modules="torch"
                )
            self._fn_cache[key] = DerivativeKernel._global_fn_cache[gkey]
        return self._fn_cache[key]

    def pair_table(self, groups1, groups2):
        """Table of derivative functions for an order-pair grid (shared
        across instances through the module-level cache)."""
        return {(a, b): self._deriv_fn(a, b) for a in groups1 for b in groups2}

    def _pair_matrix(self, x1, gid1, groups1, x2, gid2, groups2, pvals):
        return _pair_masked_matrix(x1, gid1, groups1, x2, gid2, groups2, pvals, self.pair_table(groups1, groups2))

    def _pair_diag(self, x, gid, groups, pvals):
        return _pair_masked_diag(x, gid, groups, pvals, self.pair_table(groups, groups))

    def _param_values(self, params=None, device=None):
        if params is None:
            return [_f64(p.value, device) for p in self.params.values()]
        return [_f64(params[name], device) for name in self.params]

    @staticmethod
    def _split(x, obs_dims):
        x = host_numpy(x)
        return x[:, :obs_dims], np.asarray(np.rint(x[:, obs_dims:]), dtype=np.int64)

    def _rows(self, X, device):
        x, d = self._split(X, self.obs_dims)
        groups, gid = _group_order_rows(d)
        return _f64(x, device), torch.as_tensor(gid, device=device), groups

    def K(self, X, X2=None, params=None):
        """Full kernel matrix on the GPR device, float64."""
        device = compute_device()
        x1, gid1, groups1 = self._rows(X, device)
        x2, gid2, groups2 = (x1, gid1, groups1) if X2 is None else self._rows(X2, device)
        return self._pair_matrix(x1, gid1, groups1, x2, gid2, groups2, self._param_values(params, device))

    def K_diag(self, X, params=None):
        device = compute_device()
        x, gid, groups = self._rows(X, device)
        return self._pair_diag(x, gid, groups, self._param_values(params, device))

    def __call__(self, X, X2=None, params=None):
        return self.K(X, X2, params=params)


def _make_params(specs) -> dict[str, Parameter]:
    """``{name: Parameter}`` from ``{name: Parameter | value | (value, ...)}``;
    plain values become positive parameters."""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, Parameter):
            out[name] = spec
        elif isinstance(spec, (list, tuple)):
            # reference style: (value, {kwargs}) with positive transform
            out[name] = Parameter(float(spec[0]), "positive")
        else:
            out[name] = Parameter(float(spec), "positive")
    return out


# ---------------------------------------------------------------------------
# likelihood
# ---------------------------------------------------------------------------


def _cholesky(a):
    """Lower Cholesky factor of the symmetrized ``a`` (``jnp.linalg.cholesky``
    symmetrizes its input); NaN for each matrix of the batch that is not
    positive definite, as ``jnp.linalg.cholesky`` gives, with no host read."""
    chol, info = torch.linalg.cholesky_ex(0.5 * (a + a.mT))
    return torch.where((info != 0)[..., None, None], float("nan"), chol)


def _solve_lower(chol, b):
    return torch.linalg.solve_triangular(chol, b, upper=False)


def multioutput_multivariate_normal(x, mu, chol):
    r"""Per-output-dim multivariate normal log density.

    ``x``: (N, D); ``mu``: broadcastable to (N, D); ``chol``: (D, N, N).
    Returns (D,) log probabilities.
    """
    x, mu, chol = (a if isinstance(a, torch.Tensor) else _f64(a) for a in (x, mu, chol))
    d = (x - mu).mT[..., None]  # (D, N, 1)
    alpha = _solve_lower(chol, d)[..., 0]
    n = d.shape[-2]
    return (
        -0.5 * torch.sum(alpha**2, dim=-1)
        - 0.5 * n * math.log(2.0 * math.pi)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    )


class HetGaussianDeriv:
    r"""Heteroscedastic Gaussian likelihood with fixed bootstrap noise
    covariance and trainable order-dependent scaling:

    .. math:: {\rm cov}_{ij} = {\rm cov}_{ij,0}\,
              e^{p \sum(d_i+1)} e^{p \sum(d_j+1)} e^{s}

    with ``p >= 0`` (positive transform) trainable and ``s`` frozen by
    default; jitter 1e-12 on the diagonal.
    """

    def __init__(
        self,
        cov,
        obs_dims: int,
        p: float = 10.0,
        s: float = 0.0,
        constrain_p: bool = False,
        constrain_s: bool = True,
        transform_p: str = "positive",
        transform_s: str = "none",
    ) -> None:
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim == 1:
            cov = np.diag(cov)
        # host float64; the core's bound arguments go to the GPR device per call
        self.cov = self.cov_np = cov
        self.obs_dims = int(obs_dims)
        self.params = {
            "p": Parameter(p, transform_p, trainable=not constrain_p),
            "s": Parameter(s, transform_s, trainable=not constrain_s),
        }
        self.stable_var_min = 1.0e-12

    def build_scaled_cov_mat(self, X, params=None):
        """The scaled noise covariance at rows ``X`` (the core's
        :func:`_scaled_noise_cov`), on the GPR device."""
        lik_p = {k: _f64(self.params[k].value if params is None else params[k]) for k in ("p", "s")}
        dplus = _f64(np.sum(host_numpy(X)[:, self.obs_dims :] + 1.0, axis=-1))
        return _scaled_noise_cov(_f64(self.cov), dplus, lik_p, self.stable_var_min)


class HetGaussianSimple(HetGaussianDeriv):
    r"""Provided noise covariance with ONE trainable scalar scale and no
    derivative-order dependence:

    .. math:: {\rm cov}_{\rm scaled} = {\rm scale\_noise} \cdot {\rm cov}

    The ``p=0`` (frozen) special case of :class:`HetGaussianDeriv` with
    ``s`` trainable — ``scale_noise = e^s`` — so it runs through the same
    core.
    """

    def __init__(self, cov, obs_dims: int, init_scale: float = 1.0) -> None:
        if init_scale <= 0:
            msg = f"init_scale must be positive, got {init_scale}"
            raise ValueError(msg)
        super().__init__(
            cov,
            obs_dims,
            p=0.0,
            s=float(np.log(init_scale)),
            constrain_p=True,
            constrain_s=False,
            transform_p="none",
            transform_s="none",
        )

    @property
    def scale_noise(self) -> float:
        """The learned covariance scale (reference ``scale_noise`` param)."""
        return float(np.exp(self.params["s"].value))


# ---------------------------------------------------------------------------
# mean functions; each returns a float64 (N, dim) tensor on the GPR device
# ---------------------------------------------------------------------------


class ConstantMeanWithDerivs:
    """Mean = data average at derivative order 0, zero elsewhere."""

    def __init__(self, y_data, x_dim: int = 1) -> None:
        y_data = host_numpy(y_data)
        self.c = y_data.mean(axis=0)
        self.dim = y_data.shape[1]
        self.x_dim = int(x_dim)

    def __call__(self, X):
        X = host_numpy(X)
        zero = np.all(X[:, self.x_dim :] == 0.0, axis=-1, keepdims=True)
        return torch.where(_f64(zero).bool(), _f64(self.c)[None, :], 0.0)


class LinearWithDerivs:
    """Hyperplane fit to order-0 data (host ``lstsq``); slope fills order-1 rows."""

    def __init__(self, x_data, y_data) -> None:
        x_data = np.asarray(host_numpy(x_data), dtype=np.float64)
        y_data = np.asarray(host_numpy(y_data), dtype=np.float64)
        mean_x = x_data.mean(axis=0, keepdims=True)
        mean_y = y_data.mean(axis=0, keepdims=True)
        xm = np.concatenate([np.ones((x_data.shape[0], 1)), x_data - mean_x], axis=1)
        params, *_ = np.linalg.lstsq(xm, y_data - mean_y, rcond=None)
        self.slope = params[1:, :]
        self.b = params[0, :] + mean_y - mean_x @ params[1:, :]
        self.dim = y_data.shape[1]
        self.x_dim = x_data.shape[1]

    def __call__(self, X):
        X = host_numpy(X)
        slope = _f64(self.slope)
        dords = X[:, self.x_dim :]
        mean0 = _f64(X[:, : self.x_dim]) @ slope + _f64(self.b)
        mean1 = _f64(dords) @ slope
        is0 = np.all(dords == 0.0, axis=-1, keepdims=True)
        is1 = np.any(dords == 1.0, axis=-1, keepdims=True) & np.all(dords < 2.0, axis=-1, keepdims=True)
        return torch.where(_f64(is0).bool(), mean0, 0.0) + torch.where(_f64(is1).bool(), mean1, 0.0)


class SympyMeanFunc:
    """Arbitrary sympy mean function fit to order-0 data by scipy L-BFGS;
    derivative rows evaluated by symbolic differentiation (sympy imported
    here)."""

    def __init__(self, expr, x_data, y_data, params=None, x_dim: int | None = None) -> None:
        from scipy import optimize

        sp = _import_sympy()
        x_data = np.asarray(host_numpy(x_data), dtype=np.float64)
        y_data = np.asarray(host_numpy(y_data), dtype=np.float64)
        self.dim = y_data.shape[1]
        self.x_dim = x_data.shape[1] if x_dim is None else int(x_dim)
        self.expr = expr

        x_syms, param_syms = [], []
        for s in expr.free_symbols:
            (x_syms if s.name.casefold().startswith("x") else param_syms).append(s)
        x_syms.sort(key=lambda s: s.name)
        param_syms.sort(key=lambda s: s.name)
        self.x_syms, self.param_syms = x_syms, param_syms

        p0 = np.array([float((params or {}).get(s.name, 1.0)) for s in param_syms])
        f0 = sp.lambdify((*x_syms, *param_syms), expr, modules="numpy")
        jacs = [sp.lambdify((*x_syms, *param_syms), sp.diff(expr, p, 1), modules="numpy") for p in param_syms]
        xcols = np.split(x_data, self.x_dim, axis=-1)

        def loss(p):
            return float(np.sum((f0(*xcols, *p) - y_data) ** 2))

        def jac(p):
            pre = 2.0 * (f0(*xcols, *p) - y_data)
            return np.array([np.sum(pre * j(*xcols, *p)) for j in jacs])

        opt = optimize.minimize(loss, p0, method="L-BFGS-B", jac=jac)
        self.param_values = {s.name: float(v) for s, v in zip(param_syms, opt.x)}
        self._fn_cache: dict[tuple, Callable] = {}

    def _fn(self, dd: tuple) -> Callable:
        if dd not in self._fn_cache:
            sp = _import_sympy()
            expr = sp.diff(self.expr, *zip(self.x_syms, dd))
            self._fn_cache[dd] = sp.lambdify((*self.x_syms, *self.param_syms), expr, modules="torch")
        return self._fn_cache[dd]

    def __call__(self, X):
        X = host_numpy(X)
        locs, dords = X[:, : self.x_dim], np.asarray(np.rint(X[:, self.x_dim :]), dtype=int)
        pvals = [_f64(self.param_values[s.name]) for s in self.param_syms]
        cols = [_f64(locs[:, k]) for k in range(self.x_dim)]
        n = X.shape[0]
        out = torch.zeros((n,), dtype=_F64, device=compute_device())
        for dd in {tuple(r) for r in dords}:
            vals = _full(self._fn(dd)(*cols, *pvals), (n,), out)
            mask = _f64(np.all(dords == np.asarray(dd), axis=1)).bool()
            out = torch.where(mask, vals, out)
        return torch.broadcast_to(out[:, None], (n, self.dim))


# ---------------------------------------------------------------------------
# the model core
#
# The LML, its gradient, and the posterior predictions are pure functions of
# (static structure, tensors).  Static structure = kernel form, unique
# derivative-order groups, and the parameter layout; everything else (data,
# parameter values) is an argument.  The built functions are cached at
# module level keyed on the structure, so fresh model instances built every
# active-learning iteration (same kernel, same shapes) reuse them and their
# derivative-function tables.
# ---------------------------------------------------------------------------

_COMPILED_CORE: dict = {}


def _build_param_split(spec_struct):
    """``(trainable_vec, fixed_vec) -> (kernel_params, likelihood_params)``
    for a static (name, transform, trainable) layout; fixed values arrive
    already constrained."""

    def split(vec, fixed):
        kernel_p, lik_p = {}, {}
        ti = fi = 0
        for name, transform, trainable in spec_struct:
            if trainable:
                val = _softplus(vec[ti]) if transform == "positive" else vec[ti]
                ti += 1
            else:
                val = fixed[fi]
                fi += 1
            group, key = name.split("/")
            (kernel_p if group == "kernel" else lik_p)[key] = val
        return kernel_p, lik_p

    return split


def _scaled_noise_cov(cov, dplus, lik_p, stable_var_min):
    """Order-scaled noise covariance: ``S cov S`` with
    ``S = diag(exp(p * sum(d+1) + s/2))`` and a jitter floor on the diag."""
    scale = torch.exp(lik_p["p"] * dplus + 0.5 * lik_p["s"])
    out = scale[:, None] * cov * scale[None, None, :]
    diag = torch.diagonal(out, dim1=-2, dim2=-1) + stable_var_min
    eye = torch.eye(out.shape[-1], dtype=out.dtype, device=out.device)
    return out * (1.0 - eye) + eye * diag[..., None, :] * eye


def _value_and_grad(fn):
    """``(vec, *args) -> (fn value, d fn / d vec)`` by autograd."""

    def vag(vec, *args):
        with torch.enable_grad():
            vec = vec.detach().requires_grad_(True)
            val = fn(vec, *args)
            if not val.requires_grad:  # no trainable parameter reaches the value
                return val.detach(), torch.zeros_like(vec)
            (grad,) = torch.autograd.grad(val, vec)
        return val.detach(), grad

    return vag


def _build_lml_fns(kernel, groups, spec_struct, stable_var_min):
    split = _build_param_split(spec_struct)
    param_order = tuple(kernel.params)

    def lml(vec, fixed, locs, gid, y, cov, dplus, mean_x):
        kernel_p, lik_p = split(vec, fixed)
        pvals = [kernel_p[k] for k in param_order]
        k = kernel._pair_matrix(locs, gid, groups, locs, gid, groups, pvals)
        ks = k[None] + _scaled_noise_cov(cov, dplus, lik_p, stable_var_min)
        return torch.sum(multioutput_multivariate_normal(y, mean_x, _cholesky(ks)))

    def lml_logwhitened(vec, fixed, locs, gid, y, cov, dplus, mean_x):
        """The same LML through a LOG-SPACE Jacobi-whitened Cholesky: exact
        at float64 and float32-representable.  The order-scaled noise
        diagonal ``exp(2 p d+ + s)`` can reach ~1e50 at the default
        initialization, overflowing a plain float32 ``K + S`` before any
        factorization, while the whitened matrix is near-identity
        conditioned: every factor is an ``exp`` of a difference of log
        scales, so ``K + S`` never materializes."""
        kernel_p, lik_p = split(vec, fixed)
        pvals = [kernel_p[k] for k in param_order]
        k = kernel._pair_matrix(locs, gid, groups, locs, gid, groups, pvals)
        lsc = lik_p["p"] * dplus + 0.5 * lik_p["s"]  # (N,) log noise scale
        covd = torch.diagonal(cov, dim1=-2, dim2=-1)  # (D, N)
        # exactly-zero noise-cov diagonals contribute NOTHING: (a) they are
        # masked out of ld (a clamp's phantom term would de-whiten those
        # rows), and (b) f itself is masked on zero rows, where
        # exp(lsc - ld/2) ~ exp(lsc) overflows float32 at extreme scales and
        # 0 * inf would poison W with NaN (the safe-where keeps gradients
        # finite; logaddexp(-inf, x) = x)
        zero_cov = covd <= 0
        log_covd = torch.where(zero_cov, -math.inf, torch.log(torch.where(zero_cov, 1.0, covd)))
        ld = torch.logaddexp(
            torch.log(torch.clamp(torch.diagonal(k), min=1e-30))[None, :],
            torch.logaddexp(2.0 * lsc[None, :] + log_covd, torch.full_like(covd, math.log(stable_var_min))),
        )  # (D, N) log diag(K + S)
        e = torch.exp(-0.5 * ld)
        f = torch.where(zero_cov, 0.0, torch.exp(torch.where(zero_cov, 0.0, lsc[None, :] - 0.5 * ld)))
        eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
        w = (
            k[None] * e[:, :, None] * e[:, None, :]
            + cov * f[:, :, None] * f[:, None, :]
            + (stable_var_min * e**2)[:, :, None] * eye
        )
        chol_w = _cholesky(w)
        err = (y - mean_x).mT  # (D, N)
        alpha = _solve_lower(chol_w, (err * e)[..., None])[..., 0]
        n = err.shape[-1]
        per_dim = (
            -0.5 * torch.sum(alpha**2, dim=-1)
            - 0.5 * n * math.log(2.0 * math.pi)
            - torch.sum(torch.log(torch.diagonal(chol_w, dim1=-2, dim2=-1)), dim=-1)
            - 0.5 * torch.sum(ld, dim=-1)
        )
        return torch.sum(per_dim)

    def neg(*args):
        return -lml(*args)

    def neg_logw(*args):
        return -lml_logwhitened(*args)

    return {
        "lml": lml,
        "neg_vag": _value_and_grad(neg),
        "lml_logw": lml_logwhitened,
        "neg_vag_logw": _value_and_grad(neg_logw),
    }


def _build_predict_fn(
    kernel,
    groups,
    groups_new,
    spec_struct,
    stable_var_min,
    full_cov,
    analytic_scale: bool = False,
):
    """Posterior builder; with ``analytic_scale`` the profiled global scale
    ``v* = err^T (K+S)^{-1} err / N`` of the ``v*(K+S)`` model multiplies
    the posterior variance (the mean is unchanged — the scale cancels in
    ``v kmn^T (v(K+S))^{-1} err``)."""
    split = _build_param_split(spec_struct)
    param_order = tuple(kernel.params)

    def predict(vec, fixed, locs, gid, y, cov, dplus, mean_x, locs_new, gid_new, mean_new, scale_fac):
        kernel_p, lik_p = split(vec, fixed)
        pvals = [kernel_p[k] for k in param_order]
        kmm = kernel._pair_matrix(locs, gid, groups, locs, gid, groups, pvals)
        kmn = kernel._pair_matrix(locs, gid, groups, locs_new, gid_new, groups_new, pvals)
        chol = _cholesky(kmm[None] + _scaled_noise_cov(cov, dplus, lik_p, stable_var_min))  # (D, N, N)
        err = y - mean_x  # (N, D)
        out_dim = y.shape[1]

        a = _solve_lower(chol, kmn[None].expand(out_dim, *kmn.shape))  # (D, N, M)
        b = _solve_lower(chol, err.mT[..., None])  # (D, N, 1)
        v = torch.sum(b[..., 0] ** 2, dim=1) / y.shape[0] if analytic_scale else torch.ones_like(scale_fac)
        f_mean = (torch.einsum("dnm,dn->md", a, b[..., 0]) + mean_new) * scale_fac

        if full_cov:
            knn = kernel._pair_matrix(locs_new, gid_new, groups_new, locs_new, gid_new, groups_new, pvals)
            f_var = knn[None] - torch.einsum("dnm,dnp->dmp", a, a)
            f_var = f_var * (v * scale_fac**2).reshape(-1, 1, 1)
        else:
            knn = kernel._pair_diag(locs_new, gid_new, groups_new, pvals)
            f_var = knn[None, :] - torch.sum(a**2, dim=1)
            f_var = (f_var * (v * scale_fac**2).reshape(-1, 1)).mT  # (M, D)
        return f_mean, f_var

    return predict


# ---------------------------------------------------------------------------
# the GPR model
# ---------------------------------------------------------------------------


# captured objectives, the most recent last: (objective, device, dtype, the
# operands' shapes and dtypes) -> (graph, input, operands, output)
_GRAPHS: OrderedDict = OrderedDict()
_GRAPHS_KEPT = 8


def _capture(val_and_grad, bound, x0, dtype, device):
    static_in = torch.as_tensor(x0, device=device).to(dtype)
    static_bound = tuple(b.clone() for b in bound)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        val_and_grad(static_in, *static_bound)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v, g = val_and_grad(static_in, *static_bound)
        static_out = torch.cat([v.reshape(1), g]).double()
    return graph, static_in, static_bound, static_out


def _graphed_objective(val_and_grad, bound, x0, dtype, device):
    """``replay(x) -> numpy (value, *gradient)``: ``val_and_grad`` at ``x``
    replayed from one CUDA graph.  An objective that cannot be captured (one
    that reads the host or copies from it) raises here: a fit on the card
    has no eager route.

    An eager evaluation on the card launches ~240 small kernels, each with
    its Python dispatch, so the host sets the pace; a replay launches them
    at once and the evaluation reads back its value and gradient, as the
    eager one does.  The graph holds the same kernels on the same inputs, so
    it gives the same numbers.  One eager evaluation on a side stream warms
    the libraries' handles and workspaces first, as capture requires.

    A graph is captured once for an objective and its operands' shapes, and
    the last ``_GRAPHS_KEPT`` are kept: a later fit of the same shapes copies
    its operands into the graph's and replays it, so it neither captures nor
    allocates device memory."""
    key = (val_and_grad, device, dtype, tuple((tuple(b.shape), b.dtype) for b in bound))
    if key not in _GRAPHS:
        _GRAPHS[key] = _capture(val_and_grad, bound, x0, dtype, device)
        while len(_GRAPHS) > _GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    graph, static_in, static_bound, static_out = _GRAPHS[key]
    for s, b in zip(static_bound, bound):
        s.copy_(b)

    def replay(x):
        static_in.copy_(torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dtype))
        graph.replay()
        return host_numpy(static_out)  # one read

    return replay


class TrainableGPModel:
    """Parameter plumbing + L-BFGS training over a neg-LML core.

    Subclasses provide ``_param_specs()`` (name -> :class:`Parameter`),
    ``_lml_fns()`` (dict with ``"lml"`` and ``"neg_vag"``), and
    ``_bound_args()`` (the float64 data tensors those functions take).
    Everything here — unconstrained-vector round-trip, JSON checkpointing,
    the NaN-guarded/rollback L-BFGS loop — is shared between the models.
    """

    # -- parameter plumbing ----------------------------------------------------

    def _param_specs(self):
        raise NotImplementedError

    def _lml_fns(self):
        raise NotImplementedError

    def _bound_args(self):
        raise NotImplementedError

    def trainable_names(self):
        return [k for k, p in self._param_specs().items() if p.trainable]

    def get_unconstrained(self):
        """The trainable parameters' unconstrained vector, a float64 CPU tensor."""
        specs = self._param_specs()
        return torch.stack([specs[k].unconstrain() for k in self.trainable_names()])

    def set_unconstrained(self, vec) -> None:
        vec = np.asarray(host_numpy(vec), dtype=np.float64)
        for k, raw in zip(self.trainable_names(), vec):
            p = self._param_specs()[k]
            p.value = float(p.constrain(torch.tensor(raw, dtype=_F64)))

    def parameters(self) -> dict:
        """Current constrained parameter values."""
        return {k: p.value for k, p in self._param_specs().items()}

    def set_parameters(self, values: dict) -> None:
        specs = self._param_specs()
        for k, v in values.items():
            if k in specs:
                specs[k].value = float(v)

    def _spec_struct(self):
        return tuple((k, p.transform, p.trainable) for k, p in self._param_specs().items())

    def _fixed_constrained(self):
        return np.asarray([p.value for p in self._param_specs().values() if not p.trainable], dtype=np.float64)

    # -- core math --------------------------------------------------------------

    def log_marginal_likelihood(self, vec=None):
        """The LML at ``vec`` (the current parameters when None): a 0-d
        float64 tensor on the GPR device."""
        if vec is None:
            vec = self.get_unconstrained()
        return self._lml_fns()["lml"](_f64(vec), *self._bound_args())

    def neg_lml(self, vec):
        return -self.log_marginal_likelihood(vec)

    # -- checkpointing ------------------------------------------------------------

    def save_params(self, path) -> None:
        """Save constrained parameter values as JSON."""
        import json
        from pathlib import Path

        Path(path).write_text(json.dumps(self.parameters(), indent=1))

    def load_params(self, path) -> None:
        import json
        from pathlib import Path

        self.set_parameters(json.loads(Path(path).read_text()))

    # -- training ----------------------------------------------------------------

    def train(self, max_iter: int = 1000, tol: float | None = None, on_device: bool = False):
        """scipy L-BFGS-B on the negative LML with NaN guarding and rollback.

        The objective and its gradient run on the GPR device
        (:func:`..utils.compute.compute_device`), in float64 by default.
        ``on_device=True`` takes the float32 log-space-whitened LML
        (``lml_logw`` — the only float32-representable form: the plain cast
        overflows on the order-scaled noise diagonal).  Each evaluation reads
        the value and the gradient back in one copy; on a CUDA device it is
        replayed from one CUDA graph of the objective, captured once for its shapes
        (:func:`_graphed_objective`).  ``tol`` is accepted for the
        reference's signature and not used, as there.
        """
        from scipy import optimize

        del tol
        fns = self._lml_fns()
        if on_device:
            if "neg_vag_logw" not in fns:
                msg = (
                    f"{type(self).__name__} has no log-whitened LML core; "
                    "train(on_device=True) is only available for models "
                    "whose _lml_fns provide 'neg_vag_logw' "
                    "(HeteroscedasticGPR)"
                )
                raise NotImplementedError(msg)
            val_and_grad, dtype = fns["neg_vag_logw"], torch.float32
        else:
            val_and_grad, dtype = fns["neg_vag"], _F64
        bound = tuple(b.to(dtype) if b.is_floating_point() else b for b in self._bound_args())
        device = compute_device()
        x0 = host_numpy(self.get_unconstrained()).astype(np.float64)
        replay = _graphed_objective(val_and_grad, bound, x0, dtype, device) if device.type == "cuda" else None

        def fun(x):
            GPR_LML_EVALS["n"] += 1
            if replay is not None:
                both = replay(x)
            else:
                v, g = val_and_grad(torch.as_tensor(x, device=device).to(dtype), *bound)
                both = host_numpy(torch.cat([v.reshape(1), g]).double())  # one read
            v, g = float(both[0]), both[1:]
            if not np.isfinite(v) or not np.all(np.isfinite(g)):
                # Cholesky failure region: large finite value, zero grad so
                # the line search backtracks instead of aborting
                return 1e12, np.zeros_like(g)
            return v, g

        f0, _ = fun(x0)
        res = optimize.minimize(fun, x0, jac=True, method="L-BFGS-B", options={"maxiter": max_iter})
        f_final, _ = fun(np.asarray(res.x, dtype=np.float64))
        if np.isfinite(f_final) and f_final <= f0:
            self.set_unconstrained(res.x)
        else:
            # rollback: keep the starting parameters — and make the result
            # object agree (res.fun/res.x must describe the APPLIED
            # parameters, or train_GPR's keep-the-better-optimum compare
            # can prefer a warm start that is worse than this rollback)
            res.x = x0
            res.fun = f0
        return res


class HeteroscedasticGPR(TrainableGPModel):
    """GPR with full heteroscedastic noise covariance over
    derivative-augmented inputs.

    ``data = (X (N, 2*Dx), Y (N, Dy), noise_cov (Dy, N, N) | (N, N) | (N,))``.
    Output dims are independent with a shared kernel; ``scale_fac`` equalizes
    per-dim output variance.  The data are kept on the host in float64 and
    go to the GPR device at each call; ``Y`` and ``scale_fac`` are tensors on
    the GPR device at construction.
    """

    def __init__(
        self,
        data,
        kernel: DerivativeKernel,
        mean_function=None,
        scale_fac=1.0,
        likelihood_kwargs=None,
        likelihood_class=None,
    ) -> None:
        X, Y, noise_cov = (np.asarray(host_numpy(a), dtype=np.float64) for a in data)
        self.out_dim = Y.shape[-1]

        scale_fac = np.asarray(host_numpy(scale_fac), dtype=np.float64)
        if scale_fac.ndim == 0:
            scale_fac = scale_fac * np.ones(self.out_dim)
        self._scale_np = scale_fac
        self.scale_fac = _f64(scale_fac)

        if noise_cov.ndim == 1:
            noise_cov = np.diag(noise_cov)
        if noise_cov.ndim == 2:
            noise_cov = np.tile(noise_cov[None], (self.out_dim, 1, 1))
        noise_cov = noise_cov / (scale_fac.reshape(-1, 1, 1) ** 2)

        self.kernel = kernel
        lik_cls = HetGaussianDeriv if likelihood_class is None else likelihood_class
        self.likelihood = lik_cls(noise_cov, kernel.obs_dims, **(likelihood_kwargs or {}))
        self.mean_function = mean_function
        self.X = X
        self._y_np = Y / scale_fac
        self.Y = _f64(self._y_np)

        # static structure + host float64 data for the core
        obs = kernel.obs_dims
        d = np.asarray(np.rint(X[:, obs:]), dtype=int)
        self._groups, self._gid_np = _group_order_rows(d)
        self._locs_np = np.asarray(X[:, :obs], dtype=np.float64)
        self._dplus_np = np.asarray((d + 1.0).sum(axis=-1), dtype=np.float64)
        self._mean_x_np = host_numpy(self._mean(X)).astype(np.float64)

    # -- parameter plumbing ----------------------------------------------------

    def _param_specs(self):
        specs = {f"kernel/{k}": p for k, p in self.kernel.params.items()}
        specs.update({f"likelihood/{k}": p for k, p in self.likelihood.params.items()})
        return specs

    # -- core plumbing --------------------------------------------------------------

    def _structure_key(self):
        return (
            self.kernel.structure_id(),
            self.kernel.obs_dims,
            self._groups,
            self._spec_struct(),
            float(self.likelihood.stable_var_min),
        )

    def _bound_args(self):
        """The core's data arguments: float64 tensors on the GPR device
        (the group ids int64)."""
        device = compute_device()
        return (
            _f64(self._fixed_constrained(), device),
            _f64(self._locs_np, device),
            torch.as_tensor(self._gid_np, device=device),
            _f64(self._y_np, device),
            _f64(self.likelihood.cov_np, device),
            _f64(self._dplus_np, device),
            _f64(self._mean_x_np, device),
        )

    def _lml_fns(self):
        key = ("lml", self._structure_key())
        if key not in _COMPILED_CORE:
            _COMPILED_CORE[key] = _build_lml_fns(
                self.kernel, self._groups, self._spec_struct(), float(self.likelihood.stable_var_min)
            )
        return _COMPILED_CORE[key]

    # -- core math --------------------------------------------------------------

    def _mean(self, X):
        if self.mean_function is None:
            return torch.zeros((np.shape(X)[0], self.out_dim), dtype=_F64, device=compute_device())
        return _f64(self.mean_function(X)) / _f64(self.scale_fac)

    def _predict_builder(self):
        return _build_predict_fn

    def _query(self, Xnew):
        Xnew = np.asarray(host_numpy(Xnew), dtype=np.float64)
        obs = self.kernel.obs_dims
        groups_new, gid_new = _group_order_rows(np.asarray(np.rint(Xnew[:, obs:]), dtype=int))
        return Xnew, groups_new, gid_new

    def predict_f(self, Xnew, full_cov: bool = False):
        """Posterior mean ``(M, D)`` and variance ``(M, D)`` (or covariance
        ``(D, M, M)``) at new derivative-augmented inputs: float64 tensors on
        the GPR device."""
        Xnew, groups_new, gid_new = self._query(Xnew)
        key = ("predict", self._structure_key(), groups_new, bool(full_cov))
        if key not in _COMPILED_CORE:
            _COMPILED_CORE[key] = self._predict_builder()(
                self.kernel,
                self._groups,
                groups_new,
                self._spec_struct(),
                float(self.likelihood.stable_var_min),
                bool(full_cov),
            )
        device = compute_device()
        return _COMPILED_CORE[key](
            _f64(self.get_unconstrained(), device),
            *self._bound_args(),
            _f64(Xnew[:, : self.kernel.obs_dims], device),
            torch.as_tensor(gid_new, device=device),
            self._mean(Xnew),
            _f64(self.scale_fac, device),
        )

    def predict_y(self, Xnew, **kws):
        """Not possible without a noise model at new points."""
        msg = "Predicting y requires a noise model at new points, which this likelihood does not have."
        raise NotImplementedError(msg)

    def predict_log_density(self, data, **kws):
        """Not possible without a noise model at new points."""
        msg = "Predicting log density at new points requires a noise model there, which this likelihood does not have."
        raise NotImplementedError(msg)


def predict_f_batched(models, Xnew, full_cov: bool = False):
    """Posterior predict for MANY structurally identical models in one
    batched computation (``torch.func.vmap`` of the predict core).

    Models that share a structure key (same kernel form, derivative-order
    groups, parameter layout, and data shapes) differ only in tensor VALUES,
    so a batch of them — e.g. the hypothetical data-augmented models of a
    candidate scan, or an ensemble of fits — evaluates as one computation
    over stacked arguments.  Every per-model quantity is stacked (parameters
    included), so the models may hold different data AND different
    parameter values; only the query grid ``Xnew`` is shared.

    Returns ``(mean, var)`` with leading model axis: ``(len(models), M,
    out_dim)`` each.
    """
    models = list(models)
    if not models:
        msg = "predict_f_batched needs at least one model"
        raise ValueError(msg)
    m0 = models[0]
    key0 = m0._structure_key()
    shape0 = m0.X.shape
    for m in models[1:]:
        if m._structure_key() != key0 or m.X.shape != shape0:
            msg = (
                "predict_f_batched requires structurally identical models "
                "(same kernel structure, parameter layout, and data shapes)"
            )
            raise ValueError(msg)

    Xnew, groups_new, gid_new = m0._query(Xnew)
    key = ("predict_batched", key0, groups_new, bool(full_cov))
    if key not in _COMPILED_CORE:
        base = m0._predict_builder()(
            m0.kernel, m0._groups, groups_new, m0._spec_struct(), float(m0.likelihood.stable_var_min), bool(full_cov)
        )
        # per-model things (params + data) ride axis 0; the query grid is
        # shared.  predict args: (vec, fixed, locs, gid, y, cov, dplus,
        # mean_x, locs_new, gid_new, mean_new, scale_fac)
        _COMPILED_CORE[key] = torch.func.vmap(base, in_dims=(0, 0, 0, 0, 0, 0, 0, 0, None, None, 0, 0))

    device = compute_device()
    bound = [m._bound_args() for m in models]
    stacked = [torch.stack([b[i] for b in bound]) for i in range(7)]
    return _COMPILED_CORE[key](
        torch.stack([_f64(m.get_unconstrained(), device) for m in models]),
        *stacked,
        _f64(Xnew[:, : m0.kernel.obs_dims], device),
        torch.as_tensor(gid_new, device=device),
        torch.stack([m._mean(Xnew) for m in models]),
        torch.stack([_f64(m.scale_fac, device) for m in models]),
    )


def print_summary(gpr) -> None:
    """Print a parameter/data summary of a GPR model."""
    print(f"{type(gpr).__name__}: N={gpr.X.shape[0]}, out_dim={gpr.out_dim}")
    for name, val in gpr.parameters().items():
        spec = gpr._param_specs()[name]
        flags = [spec.transform] if spec.transform != "none" else []
        if not spec.trainable:
            flags.append("frozen")
        extra = f" ({', '.join(flags)})" if flags else ""
        print(f"  {name:24s} = {val:.6g}{extra}")


def _concentrated(chol, err):
    """``(v*, logdet)`` of the profiled-scale model: ``v* = err^T (K+S)^{-1}
    err / N`` and ``sum log diag L``, per output dim."""
    alpha = _solve_lower(chol, err.mT[..., None])[..., 0]
    v = torch.sum(alpha**2, dim=-1) / err.shape[0]
    return v, torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def _build_lml_fns_vscale(kernel, groups, spec_struct, stable_var_min):
    """Concentrated (profiled) LML for the analytical-noise-scale model:
    a global per-output-dim multiplier ``v`` on ``K + S`` has the closed-form
    optimum ``v* = err^T (K+S)^{-1} err / N`` (Binois et al. 2018); plugging
    it back concentrates the likelihood to
    ``-N/2 log v* - N/2 log 2pi - sum log diag L - N/2``."""
    split = _build_param_split(spec_struct)
    param_order = tuple(kernel.params)

    def lml(vec, fixed, locs, gid, y, cov, dplus, mean_x):
        kernel_p, lik_p = split(vec, fixed)
        pvals = [kernel_p[k] for k in param_order]
        k = kernel._pair_matrix(locs, gid, groups, locs, gid, groups, pvals)
        chol = _cholesky(k[None] + _scaled_noise_cov(cov, dplus, lik_p, stable_var_min))  # (D, N, N)
        v, logdet = _concentrated(chol, y - mean_x)
        n = y.shape[0]
        return torch.sum(-0.5 * n * torch.log(v) - 0.5 * n * math.log(2.0 * math.pi) - logdet - 0.5 * n)

    def neg(*args):
        return -lml(*args)

    return {"lml": lml, "neg_vag": _value_and_grad(neg)}


def _build_predict_fn_vscale(kernel, groups, groups_new, spec_struct, stable_var_min, full_cov):
    """Posterior under the ``v*(K+S)`` model — the shared builder with the
    profiled-scale variance factor enabled."""
    return _build_predict_fn(kernel, groups, groups_new, spec_struct, stable_var_min, full_cov, analytic_scale=True)


class HeteroscedasticGPRAnalyticalScale(HeteroscedasticGPR):
    r"""Heteroscedastic derivative GPR with a closed-form global noise/signal
    scale (the reference's ``HeteroscedasticGPR_analytical_scale``).

    Models ``y ~ N(m, v (K + S))`` per output dim and profiles ``v`` out
    analytically instead of learning a trainable noise scaling, so the
    default likelihood freezes the order-dependent scaling (``p = 0``,
    i.e. ``S = noise_cov`` exactly).
    """

    def __init__(self, data, kernel, mean_function=None, scale_fac=None, likelihood_kwargs=None):
        noise_cov = np.asarray(host_numpy(data[2]), dtype=np.float64)
        if scale_fac is None:
            # reference default: sqrt of the minimum noise variance
            diag = noise_cov if noise_cov.ndim == 1 else np.diagonal(noise_cov, axis1=-2, axis2=-1)
            scale_fac = float(np.sqrt(max(diag.min(), 1e-300)))
        kws = {"p": 0.0, "constrain_p": True, "transform_p": "none"}
        kws.update(likelihood_kwargs or {})
        super().__init__(data, kernel, mean_function=mean_function, scale_fac=scale_fac, likelihood_kwargs=kws)

    def _structure_key(self):
        return ("vscale", *super()._structure_key())

    def _lml_fns(self):
        key = ("lml", self._structure_key())
        if key not in _COMPILED_CORE:
            _COMPILED_CORE[key] = _build_lml_fns_vscale(
                self.kernel, self._groups, self._spec_struct(), float(self.likelihood.stable_var_min)
            )
        return _COMPILED_CORE[key]

    def _predict_builder(self):
        return _build_predict_fn_vscale

    def calc_scale_v(self):
        """Closed-form per-output-dim scale ``v* = err^T (K+S)^{-1} err / N``
        at the current parameters: a ``(D,)`` tensor on the GPR device."""
        fixed, locs, gid, y, cov, dplus, mean_x = self._bound_args()
        kernel_p, lik_p = _build_param_split(self._spec_struct())(_f64(self.get_unconstrained()), fixed)
        pvals = [kernel_p[k] for k in self.kernel.params]
        k = self.kernel._pair_matrix(locs, gid, self._groups, locs, gid, self._groups, pvals)
        chol = _cholesky(k[None] + _scaled_noise_cov(cov, dplus, lik_p, float(self.likelihood.stable_var_min)))
        return _concentrated(chol, y - mean_x)[0]


# reference-name parity: the reference defines the snake_case class name and
# hosts the experimental noise-GP pair in this module; here they live in
# .experimental, re-exported lazily (PEP 562) to avoid a circular import
HeteroscedasticGPR_analytical_scale = HeteroscedasticGPRAnalyticalScale  # noqa: N816


def __getattr__(name: str):
    if name in ("HetGaussianNoiseGP", "FullyHeteroscedasticGPR"):
        from . import experimental

        return getattr(experimental, name)
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)

r"""Kernels of the derivative GPR (counterpart of
``thermoextrap_tpu/gpr_active/kernels.py``).

Three kernels are not sympy expressions:

- :class:`RBFDerivKernel`, the 1-D RBF, in closed form (the default kernel
  of the builders; it runs where sympy is not installed): with
  :math:`z = (x_1 - x_2)/\ell`,
  :math:`\partial_{x_1}^a \partial_{x_2}^b k = \mathrm{var}\,\ell^{-(a+b)}
  (-1)^a He_{a+b}(z)\, e^{-z^2/2}` (probabilists' Hermite polynomials by
  their recurrence), one torch computation for every order pair of the
  matrix at once;
- :class:`CallableDerivativeKernel`, over a torch callable, with mixed
  partials by nested ``torch.func.grad`` under ``torch.func.vmap``;
- :class:`ChangeInnerOuterRBFDerivKernel`, the tanh-switched RBF, written as
  a callable kernel.

The callable kernels import no sympy themselves, but ``torch.func.grad``
loads ``torch._dynamo``, which imports sympy (a dependency of torch).

``make_rbf_expr``, ``make_matern_expr`` and ``make_poly_expr`` return sympy
expressions, as in the JAX package, for
:class:`~.gp_models.DerivativeKernel`; they import sympy when called.
"""

from __future__ import annotations

import torch

from .gp_models import DerivativeKernel, Parameter, _import_sympy, _make_params

__all__ = [
    "CallableDerivativeKernel",
    "ChangeInnerOuterRBFDerivKernel",
    "RBFDerivKernel",
    "make_matern_expr",
    "make_poly_expr",
    "make_rbf_expr",
]


def make_rbf_expr(n_dims: int = 1):
    """RBF kernel expression + default parameters."""
    sp = _import_sympy()
    var = sp.symbols("var", real=True)
    if n_dims == 1:
        x1, x2, ell = sp.symbols("x1 x2 l", real=True)
        expr = var * sp.exp(-0.5 * (x1 / ell - x2 / ell) ** 2)
        params = {"var": Parameter(1.0, "positive"), "l": Parameter(1.0, "positive")}
        return expr, params
    ls = [sp.symbols(f"l_{i}", real=True) for i in range(n_dims)]
    x1s = [sp.symbols(f"x1_{i}", real=True) for i in range(n_dims)]
    x2s = [sp.symbols(f"x2_{i}", real=True) for i in range(n_dims)]
    sq = sum(((a - b) / l) ** 2 for a, b, l in zip(x2s, x1s, ls))
    expr = var * sp.exp(-0.5 * sq)
    params = {"var": Parameter(1.0, "positive")}
    params.update({f"l_{i}": Parameter(1.0, "positive") for i in range(n_dims)})
    return expr, params


def make_matern_expr(p: int):
    """Matern kernel of half-integer order ``nu = p + 1/2``."""
    sp = _import_sympy()
    d, k = sp.symbols("d k")
    poly = sp.Sum(
        (sp.factorial(p + k) / (sp.factorial(k) * sp.factorial(p - k))) * (2 * sp.sqrt(float(2 * p + 1)) * d) ** (p - k),
        (k, 0, p),
    ).doit()
    poly = poly * sp.factorial(p) / sp.factorial(2 * p)
    full = sp.simplify(poly * sp.exp(-sp.sqrt(float(2 * p + 1)) * d))
    x1, x2, ell, var = sp.symbols("x1 x2 l var", real=True)
    dist = sp.sqrt((x1 / ell - x2 / ell) ** 2)
    params = {"var": Parameter(1.0, "positive"), "l": Parameter(1.0, "positive")}
    return var * full.subs(d, dist), params


def make_poly_expr(p: int):
    """Polynomial kernel ``(var x1 x2 + l)^p``."""
    sp = _import_sympy()
    x1, x2, ell, var = sp.symbols("x1 x2 l var", real=True)
    params = {"var": Parameter(1.0, "positive"), "l": Parameter(1.0, "positive")}
    return (var * x1 * x2 + ell) ** p, params


def _rbf_hermite(x1, a, x2, b, ell, var, nmax: int):
    r"""``d^a_{x1} d^b_{x2}`` of ``var exp(-(x1 - x2)^2 / (2 l^2))``,
    elementwise over the broadcast of ``x1, a`` against ``x2, b`` (orders as
    float tensors, at most ``nmax`` together)."""
    z = (x1 - x2) / ell
    n = a + b
    he = [torch.ones_like(z), z]  # He_0, He_1; He_{k+1} = z He_k - k He_{k-1}
    for k in range(1, nmax):
        he.append(z * he[k] - k * he[k - 1])
    he_n = torch.stack(he[: nmax + 1]).gather(0, n.long().expand(z.shape)[None])[0]
    sign = 1.0 - 2.0 * torch.remainder(a, 2.0)
    return var * ell ** (-n) * sign * he_n * torch.exp(-0.5 * z * z)


def _orders(groups, gid, dtype):
    """Each row's derivative order (1-D kernels) from its group id, in the
    locations' dtype (so a float32 block stays float32).  The table is
    filled on the device, not copied from the host, so that a CUDA graph of
    the objective (:meth:`~.gp_models.TrainableGPModel.train`) can capture
    it."""
    table = torch.stack([torch.full((), float(g[0]), dtype=dtype, device=gid.device) for g in groups])
    return table[gid]


class RBFDerivKernel(DerivativeKernel):
    """The 1-D RBF derivative kernel in closed form (no sympy): parameters
    ``l`` and ``var``, in the order of the JAX package's sympy kernel."""

    def __init__(self) -> None:
        self.kernel_expr = None
        self.obs_dims = 1
        self.x_syms = []
        self.param_syms = []
        self.params = {"l": Parameter(1.0, "positive"), "var": Parameter(1.0, "positive")}
        self._fn_cache = {}

    def structure_id(self):
        return "RBFDerivKernel: var l^-(a+b) (-1)^a He_{a+b}(z) exp(-z^2/2)"

    def _deriv_fn(self, d1: tuple, d2: tuple):
        a, b = float(d1[0]), float(d2[0])
        nmax = int(a + b)

        def fn(x1, x2, ell, var):
            return _rbf_hermite(x1, torch.full_like(x1, a), x2, torch.full_like(x2, b), ell, var, nmax)

        return fn

    def _pair_matrix(self, x1, gid1, groups1, x2, gid2, groups2, pvals):
        nmax = max(g[0] for g in groups1) + max(g[0] for g in groups2)
        a, b = _orders(groups1, gid1, x1.dtype), _orders(groups2, gid2, x2.dtype)
        return _rbf_hermite(x1[:, 0, None], a[:, None], x2[None, :, 0], b[None, :], *pvals, nmax)

    def _pair_diag(self, x, gid, groups, pvals):
        a = _orders(groups, gid, x.dtype)
        return _rbf_hermite(x[:, 0], a, x[:, 0], a, *pvals, 2 * max(g[0] for g in groups))


class CallableDerivativeKernel(DerivativeKernel):
    """Derivative kernel over a plain torch callable — mixed partials by
    nested ``torch.func.grad`` under ``torch.func.vmap`` instead of sympy
    (useful when the kernel has no closed symbolic form, and where sympy is
    not installed).

    Parameters
    ----------
    fn :
        ``fn(x1, x2, *param_values) -> scalar`` with ``x1, x2`` length-
        ``obs_dims`` tensors and parameters 0-d tensors, in the order of
        ``kernel_params``.
    obs_dims, kernel_params :
        As for :class:`~.gp_models.DerivativeKernel` (``kernel_params`` is
        required: it defines parameter names/order).
    """

    def __init__(self, fn, obs_dims: int = 1, kernel_params=None) -> None:
        if not kernel_params:
            msg = "kernel_params (name -> Parameter/value) is required"
            raise ValueError(msg)
        self.fn = fn
        self.obs_dims = int(obs_dims)
        self.kernel_expr = None
        self.x_syms = []
        self.param_syms = []
        self.params = _make_params(kernel_params)
        self._fn_cache = {}

    def structure_id(self):
        # the callable IS the functional form; the core caches key on the
        # object itself (hashable by identity — the cache entry keeps it
        # alive, so the identity stays unique)
        return self.fn

    def _deriv_fn(self, d1: tuple, d2: tuple):
        key = (tuple(d1), tuple(d2))
        if key not in self._fn_cache:
            g = self.fn
            for argnum, orders in ((0, d1), (1, d2)):
                for k, n in enumerate(orders):
                    for _ in range(int(n)):
                        g = (lambda f, a=argnum, kk=k: lambda *args: torch.func.grad(f, argnums=a)(*args)[kk])(g)

            def eval_fn(*flat, _g=g, _d=self.obs_dims):
                cols1, cols2 = flat[:_d], flat[_d : 2 * _d]
                pvals = flat[2 * _d :]
                x1 = torch.stack(torch.broadcast_tensors(*cols1), dim=-1)
                x2 = torch.stack(torch.broadcast_tensors(*cols2), dim=-1)
                x1, x2 = torch.broadcast_tensors(x1, x2)
                out = torch.func.vmap(lambda a, b: _g(a, b, *pvals))(x1.reshape(-1, _d), x2.reshape(-1, _d))
                return out.reshape(x1.shape[:-1])

            self._fn_cache[key] = eval_fn
        return self._fn_cache[key]


def _change_inner_outer(x1, x2, c1, c2, l_in, l_out, s, var):
    """Outer RBF for ``x <= c1`` or ``x >= c2``, inner RBF between, joined
    by ``0.5 (1 + tanh(s (x - c)))`` switches."""
    k_out = var * torch.exp(-0.5 * (x1[0] / l_out - x2[0] / l_out) ** 2)
    k_in = var * torch.exp(-0.5 * (x1[0] / l_in - x2[0] / l_in) ** 2)

    def sig(x, c):
        return 0.5 * (1.0 + torch.tanh(s * (x - c)))

    def low(c):
        return (1.0 - sig(x1[0], c)) * (1.0 - sig(x2[0], c))

    def hi(c):
        return sig(x1[0], c) * sig(x2[0], c)

    return k_out * low(c1) + hi(c1) * k_in * low(c2) + hi(c2) * k_out


class ChangeInnerOuterRBFDerivKernel(CallableDerivativeKernel):
    """Two-changepoint tanh-switched RBF: outer kernel for ``x <= c1`` or
    ``x >= c2``, inner kernel between.  A callable kernel (no sympy); its
    parameters are in the JAX package's order (sorted by name)."""

    def __init__(self, c1: float = -7.0, c2: float = -2.0) -> None:
        params = {
            "c1": Parameter(c1, "none", trainable=False),
            "c2": Parameter(c2, "none", trainable=False),
            "l_in": Parameter(1.0, "positive"),
            "l_out": Parameter(1.0, "positive"),
            "s": Parameter(10.0, "positive", trainable=False),
            "var": Parameter(1.0, "positive"),
        }
        super().__init__(_change_inner_outer, 1, kernel_params=params)

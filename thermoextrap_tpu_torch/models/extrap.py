r"""Extrapolation and interpolation models.

Counterpart of ``thermoextrap_tpu/models/extrap.py``: ``ExtrapModel``,
``StateCollection``, ``ExtrapWeightedModel``, ``InterpModel``,
``InterpModelPiecewise``, ``PerturbModel``, ``MBARModel`` (on
:mod:`.mbar`) and ``predict_fn``.  An array-valued ``alpha`` of shape ``(A,)`` gives
outputs ``(A, *rest)``, ``rest`` being the coefficient batch shape
(replicates, values, ...).

The interpolation models solve the joint derivative-matching system in
float64 on the device of the states' derivatives, in a centered and scaled
variable (:func:`_interp_fit`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops.series import derivs_from_coefs
from ..utils import trace
from ..utils.device import default_device, to_device
from .derivatives import Derivatives

__all__ = [
    "ExtrapModel",
    "ExtrapWeightedModel",
    "InterpModel",
    "InterpModelPiecewise",
    "MBARModel",
    "PerturbModel",
    "StateCollection",
    "eval_abs_poly",
    "joint_interp_coefs",
    "predict_fn",
    "xr_weights_minkowski",
]


def _alpha_powers(dalpha, order: int):
    """(A, order+1) or (order+1,) power stack."""
    out = [torch.ones_like(dalpha)]
    for _ in range(order):
        out.append(out[-1] * dalpha)
    return torch.stack(out, dim=-1)


def _poly_eval(coefs, dalpha, *, cumsum: bool = False, no_sum: bool = False):
    """Evaluate ``sum_m coefs[m] * dalpha^m``.

    ``coefs (order+1, *rest)``; ``dalpha`` a scalar or ``(A,)`` tensor.
    Returns ``(*A, *rest)``, or the terms with their order axis kept for
    ``cumsum`` / ``no_sum``.
    """
    order = coefs.shape[0] - 1
    dalpha = torch.as_tensor(dalpha, dtype=coefs.dtype, device=coefs.device)
    p = _alpha_powers(dalpha, order)
    terms = p.reshape(p.shape + (1,) * (coefs.ndim - 1)) * coefs
    if no_sum:
        return terms
    if cumsum:
        return torch.cumsum(terms, dim=dalpha.ndim)
    return terms.sum(dim=dalpha.ndim)


def _frame(alpha0s) -> tuple[float, float]:
    """``(center, scale)`` mapping the states onto ``t = (alpha - center) /
    scale`` in ``[-1, 1]``."""
    lo, hi = min(alpha0s), max(alpha0s)
    return 0.5 * (lo + hi), (0.5 * (hi - lo)) or 1.0


def _matching_matrix(nodes, order: int) -> np.ndarray:
    """The ``(porder+1)^2`` matching matrix in Taylor-coefficient form,
    float64: row ``(t, j)`` holds the ``j``-th Taylor coefficient
    ``C(p, j) t^(p-j)`` of every power ``t^p`` at the node ``t``."""
    porder = len(nodes) * (order + 1) - 1
    return np.array(
        [
            [math.comb(p, j) * t ** (p - j) if p >= j else 0.0 for p in range(porder + 1)]
            for t in nodes
            for j in range(order + 1)
        ],
        dtype=np.float64,
    )


def _interp_fit(alpha0s, derivs_list, order: int):
    """The joint polynomial through all states as ``(b, center, scale)``:
    ``p(alpha) = sum_p b[p] t^p`` with ``t = (alpha - center) / scale``.

    ``derivs_list`` holds one ``(order+1, *rest)`` unnormalized derivative
    stack per state; extra ``rest`` axes (a replicate batch) ride through the
    solve's right-hand side.  The reference solves for the powers of
    ``alpha`` itself, a system of condition ~``alpha^porder`` (1.2e20 for
    states 5.2 and 6.0 at order 6) whose solution, from derivatives with any
    sampling noise, has coefficients of 1e8-1e9 that cancel to ~1e-4 when
    evaluated.  Here the states sit at ``t`` in ``[-1, 1]`` and the rows
    match Taylor coefficients, ``d^j p / dt^j / j! = scale^j f^(j) / j!``:
    condition 6e4 for those states, the same polynomial in exact arithmetic.
    The system is solved in float64 by :func:`torch.linalg.solve_ex` on the
    derivatives' device, without a host synchronization; a singular system
    (two equal ``alpha0``) gives non-finite values, as an unchecked LU
    solve does.
    """
    alpha0s = [float(a) for a in alpha0s]
    center, scale = _frame(alpha0s)
    derivs = torch.cat([torch.as_tensor(d).to(torch.float64) for d in derivs_list], dim=0)
    porder = derivs.shape[0] - 1
    rest = derivs.shape[1:]
    # f^(j) -> the j-th Taylor coefficient in t
    per_row = torch.tensor(
        [scale**j / math.factorial(j) for _ in alpha0s for j in range(order + 1)], dtype=torch.float64
    ).to(derivs.device)
    rhs = derivs.reshape(porder + 1, -1) * per_row[:, None]
    mat = torch.as_tensor(
        _matching_matrix([(a - center) / scale for a in alpha0s], order), dtype=torch.float64, device=derivs.device
    )
    b = torch.linalg.solve_ex(mat, rhs)[0]
    return b.reshape((porder + 1, *rest)), center, scale


def _interp_eval(fit, alpha):
    """Evaluate a fit of :func:`_interp_fit` at ``alpha``."""
    b, center, scale = fit
    alpha = torch.as_tensor(alpha, dtype=b.dtype, device=b.device)
    return _poly_eval(b, (alpha - center) / scale)


def _absolute_coefs(fit):
    """The fit's coefficients of the powers of ``alpha`` itself:
    ``a[q] = sum_p b[p] C(p, q) (-center)^(p-q) / scale^p``."""
    b, center, scale = fit
    n = b.shape[0]
    conv = np.array(
        [[math.comb(p, q) * (-center) ** (p - q) / scale**p if p >= q else 0.0 for p in range(n)] for q in range(n)]
    )
    conv = torch.as_tensor(conv, dtype=torch.float64, device=b.device)
    return (conv @ b.reshape(n, -1)).reshape(b.shape)


def joint_interp_coefs(alpha0s, derivs_list, order: int):
    """Coefficients of the joint polynomial through all states in powers of
    absolute ``alpha`` (the reference's form, for :func:`eval_abs_poly`);
    ``derivs_list`` holds one ``(order+1, *rest)`` unnormalized derivative
    stack per state.  Solved as :func:`_interp_fit`, then expanded; the
    models and the streaming pipeline evaluate the fit itself, which keeps
    the digits this expansion cancels."""
    return _absolute_coefs(_interp_fit(alpha0s, derivs_list, order))


def eval_abs_poly(coefs, alpha):
    """Evaluate the joint polynomial in absolute ``alpha`` (the interpolation
    convention; extrapolation uses powers of ``alpha - alpha0``)."""
    alpha = torch.as_tensor(alpha, dtype=coefs.dtype, device=coefs.device)
    return _poly_eval(coefs, alpha)


def _alpha_list(alpha):
    """``(alphas as floats, scalar?)`` of a number, sequence, array or tensor."""
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.detach().cpu().numpy()
    return [float(a) for a in np.atleast_1d(np.asarray(alpha))], np.ndim(alpha) == 0


class ExtrapModel:
    """Taylor-series extrapolation in ``alpha`` about ``alpha0``."""

    def __init__(
        self,
        alpha0: float,
        data: Any,
        derivatives: Derivatives,
        order: int | None = None,
        minus_log: bool = False,
        alpha_name: str = "alpha",
    ) -> None:
        self.alpha0 = float(alpha0)
        self.data = data
        self.derivatives = derivatives
        self.order = int(data.order if order is None else order)
        self.minus_log = bool(minus_log)
        self.alpha_name = alpha_name
        self._coef_cache: dict = {}

    def __call__(self, *args, **kws):
        return self.predict(*args, **kws)

    def coefs(self, order=None, minus_log=None):
        order = self.order if order is None else int(order)
        minus_log = self.minus_log if minus_log is None else bool(minus_log)
        key = (order, minus_log)
        if key not in self._coef_cache:
            self._coef_cache[key] = self.derivatives.coefs(
                data=self.data, order=order, minus_log=minus_log
            )
        return self._coef_cache[key]

    def derivs(self, order=None, minus_log=None, norm=False):
        c = self.coefs(order=order, minus_log=minus_log)
        return c if norm else derivs_from_coefs(c)

    def predict(self, alpha, order=None, minus_log=None, cumsum: bool = False, no_sum: bool = False):
        coefs = self.coefs(order=order, minus_log=minus_log)
        alpha = torch.as_tensor(alpha, dtype=coefs.dtype, device=coefs.device)
        return _poly_eval(coefs, alpha - self.alpha0, cumsum=cumsum, no_sum=no_sum)

    def resample(self, sampler, **kws):
        return type(self)(
            alpha0=self.alpha0,
            data=self.data.resample(sampler, **kws),
            derivatives=self.derivatives,
            order=self.order,
            minus_log=self.minus_log,
            alpha_name=self.alpha_name,
        )


class StateCollection:
    """A sequence of models, one per state (``alpha0``)."""

    def __init__(self, states: Sequence, **kws) -> None:
        self.states = list(states)
        self.kws = kws

    def __call__(self, *args, **kws):
        return self.predict(*args, **kws)

    def __len__(self) -> int:
        return len(self.states)

    def __getitem__(self, idx):
        return self.states[idx]

    def __iter__(self):
        return iter(self.states)

    @property
    def alpha_name(self):
        return getattr(self[0], "alpha_name", "alpha")

    @property
    def order(self):
        return min(m.order for m in self)

    @property
    def alpha0(self):
        return [m.alpha0 for m in self]

    def resample(self, sampler, **kws):
        """Resample every state: one sampler per state (a list or tuple) or
        one shared by all."""
        samplers = sampler if isinstance(sampler, (list, tuple)) else [sampler] * len(self)
        if len(samplers) != len(self):
            msg = f"{len(samplers)=} must equal {len(self)=}"
            raise ValueError(msg)
        return type(self)([s.resample(smp, **kws) for s, smp in zip(self.states, samplers)], **self.kws)

    def map(self, func, *args, **kws):
        if isinstance(func, str):
            return [getattr(s, func)(*args, **kws) for s in self]
        return [func(s, *args, **kws) for s in self]

    def map_concat(self, func, *args, **kws):
        """Apply ``func`` (a callable or a method name) to every state and
        stack the results along a new leading axis, in ``self.alpha0``
        order."""
        return torch.stack([torch.as_tensor(o) for o in self.map(func, *args, **kws)])

    def append(self, states, sort: bool = True, key: Callable | None = None):
        new_states = list(self.states) + list(states)
        if sort:
            new_states = sorted(new_states, key=key if key is not None else (lambda m: m.alpha0))
        return type(self)(new_states, **self.kws)

    def _check_alpha(self, alpha, bounded: bool = False) -> None:
        if bounded:
            lb, ub = self[0].alpha0, self[-1].alpha0
            for a in _alpha_list(alpha)[0]:
                if a < lb or a > ub:
                    msg = f"{a} outside of bounds [{lb}, {ub}]"
                    raise ValueError(msg)


def xr_weights_minkowski(deltas, m: int = 20, axis: int = 0):
    """Minkowski blend weights ``1 - d^m / sum d^m`` of the distances
    ``deltas`` to the states.

    The weights are scale invariant in ``deltas``, so the deltas are divided
    by their largest before the ``m``-th power: in float32 a raw ``delta**20``
    underflows to 0 below ~0.006, which made the weights 0/0 for closely
    spaced states.  All-zero deltas give equal weights.
    """
    deltas = deltas if isinstance(deltas, torch.Tensor) else torch.as_tensor(np.asarray(deltas), device=default_device())
    scale = deltas.abs().amax(dim=axis, keepdim=True)
    deltas_m = (deltas / torch.where(scale > 0, scale, torch.ones_like(scale))) ** m
    s = deltas_m.sum(dim=axis, keepdim=True)
    deltas_m = torch.where(s > 0, deltas_m, torch.ones_like(deltas_m))
    return 1.0 - deltas_m / deltas_m.sum(dim=axis, keepdim=True)


class _PiecewiseMixin:
    """Selection of the two states that bracket (or are nearest to) an alpha."""

    def _indices_between_alpha(self, alpha):
        idx = int(np.digitize(alpha, self.alpha0, right=False)) - 1
        idx = min(max(idx, 0), len(self) - 2)
        return [idx, idx + 1]

    def _indices_nearest_alpha(self, alpha):
        dalpha = np.abs(np.asarray(self.alpha0) - alpha)
        return [int(i) for i in np.argsort(dalpha)[:2]]

    def _indices_alpha(self, alpha, method):
        if method is None or method == "between":
            return self._indices_between_alpha(alpha)
        if method == "nearest":
            return self._indices_nearest_alpha(alpha)
        msg = f"unknown method {method}"
        raise ValueError(msg)


class ExtrapWeightedModel(StateCollection, _PiecewiseMixin):
    """Minkowski-weighted blend of the extrapolations from the two states
    that bracket each alpha (from both states when there are two)."""

    def predict(self, alpha, order=None, minus_log=None, method=None, bounded: bool = False):
        self._check_alpha(alpha, bounded)
        order = self.order if order is None else order
        alphas, scalar = _alpha_list(alpha)
        outs = []
        for a in alphas:
            states = self.states if len(self) == 2 else [self[i] for i in self._indices_alpha(a, method)]
            preds = torch.stack([m.predict(a, order=order, minus_log=minus_log) for m in states])
            deltas = torch.tensor(
                [abs(a - m.alpha0) for m in states], dtype=torch.float64, device=preds.device
            ).reshape((-1,) + (1,) * (preds.ndim - 1))
            w = xr_weights_minkowski(deltas, axis=0)
            outs.append((preds * w).sum(0) / w.sum(0))
        out = torch.stack(outs)
        return out[0] if scalar else out


class InterpModel(StateCollection):
    """The joint polynomial through all states: it matches every state's
    derivatives up to the collection's order at that state's ``alpha0``
    (:func:`_interp_fit`).

    Examples
    --------
    Two order-1 states recover a cubic observable exactly (the joint
    polynomial matches values and slopes at both ends):

    >>> import numpy as np
    >>> from types import SimpleNamespace
    >>> from thermoextrap_tpu_torch.models.derivatives import Derivatives
    >>> f = lambda a: a**3 - 2 * a  # noqa: E731
    >>> df = lambda a: 3 * a**2 - 2  # noqa: E731
    >>> def make_state(alpha):
    ...     d = Derivatives.from_funcs(
    ...         [lambda a=alpha: np.float64(f(a)), lambda a=alpha: np.float64(df(a))]
    ...     )
    ...     data = SimpleNamespace(derivs_args=(), order=1)
    ...     return ExtrapModel(alpha0=alpha, data=data, derivatives=d, order=1)
    >>> m = InterpModel([make_state(0.0), make_state(2.0)])
    >>> round(float(m.predict(1.0)), 10)  # 1 - 2 = -1
    -1.0
    """

    def fit(self, order=None, minus_log=None):
        """The joint polynomial as ``(b, center, scale)`` of
        :func:`_interp_fit`, cached per ``(order, minus_log)``: a piecewise
        model asks once per alpha."""
        order = self.order if order is None else int(order)
        key = (order, minus_log)
        cache = self.__dict__.setdefault("_fit_cache", {})
        if key not in cache:
            derivs = [m.derivs(order=order, minus_log=minus_log, norm=False) for m in self.states]
            cache[key] = _interp_fit(self.alpha0, derivs, order)
        return cache[key]

    def coefs(self, order=None, minus_log=None):
        """The joint coefficients in powers of absolute alpha ``(porder+1,
        *rest)``, float64."""
        return _absolute_coefs(self.fit(order=order, minus_log=minus_log))

    def predict(self, alpha, order=None, minus_log=None):
        return _interp_eval(self.fit(order=order, minus_log=minus_log), alpha)


class InterpModelPiecewise(StateCollection, _PiecewiseMixin):
    """Interpolation between the two states that bracket each alpha."""

    def __init__(self, states, **kws) -> None:
        super().__init__(states, **kws)
        self._pair_cache: dict = {}

    def single_interpmodel(self, i: int, j: int) -> InterpModel:
        key = (i, j)
        if key not in self._pair_cache:
            self._pair_cache[key] = InterpModel([self[i], self[j]])
        return self._pair_cache[key]

    def predict(self, alpha, order=None, minus_log=None, method=None, bounded: bool = False):
        self._check_alpha(alpha, bounded)
        alphas, scalar = _alpha_list(alpha)
        outs = []
        for a in alphas:
            i, j = (0, 1) if len(self) == 2 else self._indices_alpha(a, method)
            outs.append(self.single_interpmodel(int(i), int(j)).predict(a, order=order, minus_log=minus_log))
        out = torch.stack(outs)
        return out[0] if scalar else out


def _weighted_sums(e, xflat):
    """``sum_n e[a, n] xflat[n, k]`` → ``(A, V)``.  Up to 8 value columns
    take an elementwise product and torch's tree reduction per column, which
    holds float32 accuracy over 1e7-1e8 samples where a float32 matrix
    product with so long a contraction does not; wider ``xflat`` takes the
    matrix product."""
    v = xflat.shape[1]
    if 1 <= v <= 8:
        return torch.stack([(e * xflat[:, k]).sum(dim=1) for k in range(v)], dim=1)
    return e @ xflat


class PerturbModel:
    """Exponential-reweighting perturbation about ``alpha0``, stabilized with
    a max shift (equivalent to logsumexp).  ``data`` is a values-backed
    container (``uv (R,)``, ``xv (R, *val)``); its weights are not read, as
    in the reference."""

    def __init__(self, alpha0: float, data: Any, alpha_name: str = "alpha") -> None:
        self.alpha0 = float(alpha0)
        self.data = data
        self.alpha_name = alpha_name

    def predict(self, alpha):
        uv = self.data.uv
        xv = self.data.xv
        alpha = torch.as_tensor(alpha, dtype=uv.dtype, device=uv.device)
        alphas = torch.atleast_1d(alpha)
        expo = -(alphas - self.alpha0)[:, None] * uv[None, :]  # (A, R)
        ev = expo.sub_(expo.max(dim=1, keepdim=True).values).exp_()
        xflat = xv.reshape(uv.shape[0], -1)
        out = (_weighted_sums(ev, xflat) / ev.sum(dim=1)[:, None]).reshape((alphas.shape[0], *xv.shape[1:]))
        return out[0] if alpha.ndim == 0 else out

    def __call__(self, *args, **kws):
        return self.predict(*args, **kws)

    def resample(self, sampler, **kws):
        return type(self)(
            alpha0=self.alpha0,
            data=self.data.resample(sampler, **kws),
            alpha_name=self.alpha_name,
        )


def mbar_alpha_chunk(n_alphas: int, n_samples: int) -> int:
    """Targets a block of :func:`.mbar.mbar_expectations_alphas`'s plain
    route takes in :class:`MBARModel`: as many as keep a ``(chunk, N)`` block
    within 2^27 elements, at least one and at most all (the CUDA kernel takes
    every target in one pass and reads no block size)."""
    return max(1, min(n_alphas, (1 << 27) // n_samples))


def _mbar_predict_core(uv, xv, alpha0, alphas, method: str = "hybrid"):
    """Pooled-sample MBAR solve and the expectations at every target.

    ``uv (K, R)``, ``xv (K, R, *val)``, ``alpha0 (K,)``, ``alphas (A,)`` →
    ``(A, V)``.  The targets ``alphas[a] * u`` go to
    :func:`.mbar.mbar_expectations_alphas` (the same products as the
    reference's ``(A, N)`` grid): on the card one kernel pass over the
    samples, elsewhere blocks of :func:`mbar_alpha_chunk`, so no ``(A, N)``
    matrix is built."""
    from .mbar import mbar_expectations_alphas, mbar_solve

    with trace.span("te.mbar.solve"):
        # reduced potential of every state evaluated on all pooled samples
        u_flat = uv.reshape(-1)
        u_kn = alpha0[:, None] * u_flat[None, :]  # (K, K*R)
        n_k = torch.full((uv.shape[0],), float(uv.shape[-1]), dtype=uv.dtype, device=uv.device)
        f_k = mbar_solve(u_kn, n_k, method=method)
    with trace.span("te.mbar.grid"):
        chunk = mbar_alpha_chunk(alphas.shape[0], u_flat.shape[0])
        return mbar_expectations_alphas(u_kn, n_k, f_k, alphas, u_flat, xv.reshape(u_flat.shape[0], -1), chunk=chunk)


class MBARModel(StateCollection):
    """Multistate Bennett acceptance ratio reweighting over the pooled
    samples of every state, solved by the Newton / self-consistent hybrid of
    :mod:`.mbar` on the samples' device (the reference delegates to
    ``pymbar``).  The states' samples are stacked ``(K, R)`` state by state
    on their own device; the state energies are ``alpha0`` times ``uv`` in
    the samples' type.  ``predict`` is the call span ``te.mbar`` with the
    stages ``te.mbar.pool`` (the stacking), ``te.mbar.solve`` and
    ``te.mbar.grid`` (:mod:`..utils.trace`)."""

    def _pooled(self, alpha):
        uv = torch.stack([m.data.uv for m in self])  # (K, R)
        xv = torch.stack([m.data.xv for m in self])  # (K, R, *val)
        alpha0 = to_device([m.alpha0 for m in self], uv.device, uv.dtype)
        alpha = to_device(alpha, uv.device, uv.dtype)
        return uv, xv, alpha0, torch.atleast_1d(alpha), alpha.ndim == 0

    def predict(self, alpha, method: str = "hybrid"):
        with trace.call("te.mbar"):
            with trace.span("te.mbar.pool"):
                uv, xv, alpha0, alphas, scalar = self._pooled(alpha)
            out = _mbar_predict_core(uv, xv, alpha0, alphas, method=method)
            out = out.reshape((alphas.shape[0], *xv.shape[2:]))
            return out[0] if scalar else out

    def predict_ci(self, alpha, nrep: int = 100, seed: int = 0, method: str = "hybrid", rep_chunk: int = 2):
        """Bootstrap ``(mean, std)`` of the reweighted prediction: each
        Poisson replicate re-solves the weighted MBAR problem and re-evaluates
        every target (:func:`.mbar.mbar_bootstrap_expectations`, counts drawn
        from a generator seeded with ``seed`` on the samples' device)."""
        from .mbar import mbar_bootstrap_expectations

        uv, xv, alpha0, alphas, scalar = self._pooled(alpha)
        u_flat = uv.reshape(1, -1)
        mean, std = mbar_bootstrap_expectations(
            alpha0[:, None] * u_flat,
            [uv.shape[-1]] * len(self),
            alphas[:, None] * u_flat,
            xv.reshape(u_flat.shape[1], -1),
            nrep=nrep,
            rng=seed,
            method=method,
            rep_chunk=rep_chunk,
        )
        shape = (alphas.shape[0], *xv.shape[2:])
        mean, std = mean.reshape(shape), std.reshape(shape)
        return (mean[0], std[0]) if scalar else (mean, std)

    def resample(self, *args, **kws):
        msg = (
            "resample not implemented for MBARModel (as in the reference); "
            "use predict_ci(alpha, nrep=) for bootstrap uncertainties"
        )
        raise NotImplementedError(msg)


def predict_fn(model: ExtrapModel):
    """A plain ``fn(alpha) -> prediction`` closing over the model's
    coefficients, for embedding a prediction in larger torch programs
    (autograd flows through ``alpha``)."""
    coefs = model.coefs()
    alpha0 = model.alpha0

    def fn(alpha):
        return _poly_eval(coefs, torch.as_tensor(alpha, dtype=coefs.dtype, device=coefs.device) - alpha0)

    return fn

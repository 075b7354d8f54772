r"""MBAR (multistate Bennett acceptance ratio) in torch.

Counterpart of ``thermoextrap_tpu/models/mbar.py``.  The self-consistent
equations (Shirts & Chodera 2008)

.. math::

    f_k = -\log \sum_n \frac{\exp(-u_k(x_n))}
          {\sum_j N_j \exp(f_j - u_j(x_n))}

are solved by the Newton / self-consistent hybrid (pymbar's production
"adaptive" solver), with the plain fixed point kept as ``method="sci"``.
The Newton step works on the unconstrained objective (gauge ``f_0 = 0``):
gradient :math:`N_k (S_k - 1)` with :math:`S_k = \sum_n \tilde W_{kn}`, and
Hessian :math:`\delta_{kl} N_k S_k - N_k N_l (\tilde W \tilde W^T)_{kl}`, one
``(K, N) @ (N, K)`` product per iteration.

Every sample-axis reduction is a ``torch.logsumexp`` or a sum over the last
axis of ``(..., K, N)`` blocks on ``u_kn``'s device; masked samples carry
``log_sample_weight = -inf`` (``logsumexp`` of an all ``-inf`` row is
``-inf``, as in ``jax.scipy``).  The solver core and the grid take an
optional process group, over whose ranks the samples are sharded
(:mod:`..parallel.sharded`): each such reduction then all-reduces its
partial sums, a log-sum-exp as the MAX of the local maxima and the SUM of
the shifted exponentials.  The reference's ``lax.while_loop`` is a
Python loop that reads ``res > tol`` on the host once per iteration
(through :func:`..utils.device.host_item`, so each read is counted in
``host_syncs``); the counter ``mbar_iters`` (:data:`MBAR_ITERS`, held in
:data:`..utils.trace.COUNTERS`) gains each solve's iterations.  The
solver core is batched over leading replicate axes, with a per-replicate
"done" mask that freezes a converged replicate's carry, which is what the
reference's ``vmap`` of the ``while_loop`` does, so each bootstrap replicate
solves as it would alone.  The ``K x K`` algebra of :func:`mbar_covariance`
runs in float64 on ``u_kn``'s device (the card has float64 ``eigh``; the
reference pins it to host numpy because the TPU has none).

Numpy inputs go to :func:`..utils.device.default_device`; tensors keep
their device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..data import _as_tensor
from ..ops.resample import poisson1_freq
from ..utils import trace
from ..utils.device import host_item
from ..utils.random import validate_rng
from .extrap import _weighted_sums

__all__ = [
    "MBAR_ITERS",
    "mbar_bootstrap_expectations",
    "mbar_covariance",
    "mbar_expectations",
    "mbar_expectations_alphas",
    "mbar_expectations_grid",
    "mbar_fe_uncertainties",
    "mbar_log_weights",
    "mbar_overlap",
    "mbar_perturbed_free_energies",
    "mbar_solve",
    "mbar_solve_info",
    "statistical_inefficiency",
    "subsample_correlated_data",
]

# iterations of the solver: each a self-consistent update or a hybrid step
# over ``u_kn`` (a batched solve counts its loop's iterations once)
MBAR_ITERS = trace.register("mbar_iters", {"n": 0})


def _tensor(a, device=None, dtype=None):
    """:func:`..data._as_tensor` (the default device rule), cast to ``dtype``."""
    t = _as_tensor(a, device)
    return t if dtype is None else t.to(dtype)


def _lse(t, group=None, keepdim: bool = False):
    """Log-sum-exp over the last (sample) axis; with a process group, over
    the samples of every rank (an empty block contributes nothing)."""
    if group is None:
        return torch.logsumexp(t, dim=-1, keepdim=keepdim)
    if t.shape[-1]:
        m = t.amax(dim=-1, keepdim=True)
    else:
        m = t.new_full((*t.shape[:-1], 1), -torch.inf)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    # torch.logsumexp's rule: an infinite maximum shifts by 0
    m = torch.where(m.abs() == torch.inf, torch.zeros_like(m), m)
    s = _sum(torch.exp(t - m), group, keepdim=True)
    out = torch.log(s) + m
    return out if keepdim else out.squeeze(-1)


def _sum(t, group=None, keepdim: bool = False):
    """Sum over the last (sample) axis, all-reduced over ``group``."""
    s = t.sum(dim=-1, keepdim=keepdim)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def _masked(t, logm):
    """Add the per-sample log weight ``logm (..., N)`` to ``t (..., K, N)`` in place."""
    return t if logm is None else t.add_(logm[..., None, :])


# Each core function takes ``f_k (..., K)``, ``log_n_k (..., K)`` and
# ``logm (..., N)`` with the same leading axes (none for one problem, the
# replicates for the bootstrap) against one shared ``u_kn (K, N)``.


def _gram(w, group=None):
    """``w @ w^T`` over the sample axis of ``w (..., K, N)``, one product and
    sum per row: torch's tree reduction keeps float32 sums over 1e8 samples
    where a float32 matrix product with so long a contraction loses digits,
    and the batched product of ``(B, K, N)`` blocks takes cuBLAS's slow
    skinny-matrix kernel."""
    g = torch.stack([(w[..., i : i + 1, :] * w).sum(dim=-1) for i in range(w.shape[-2])], dim=-2)
    if group is not None:
        dist.all_reduce(g, group=group)
    return g


def _columns(x_n):
    """``x_n (N, *val)`` as ``(N, V)`` with each column contiguous (column
    major), so that each weighted column sum reads its column in one sweep."""
    x = x_n.reshape(x_n.shape[0], -1)
    return x.T.contiguous().T


def _log_denom(f_k, u_kn, log_n_k):
    """Log mixture denominator per sample, ``log sum_j N_j exp(f_j - u_jn)``: ``(..., N)``."""
    return torch.logsumexp((log_n_k + f_k)[..., :, None] - u_kn, dim=-2)


def _self_consistent_update(f_k, u_kn, log_n_k, logm=None, log_denom=None, group=None):
    ld = _log_denom(f_k, u_kn, log_n_k) if log_denom is None else log_denom
    # -(u + ld) is -u - ld to the bit: rounding is symmetric in sign
    t = _masked((u_kn + ld[..., None, :]).neg_(), logm)
    f_new = -_lse(t, group)
    return f_new - f_new[..., :1]


def _residual(f_k, u_kn, log_n_k, logm=None, log_denom=None, group=None):
    """Per-state self-consistency residual ``S_k - 1`` (0 at the solution;
    its largest magnitude is the convergence measure)."""
    ld = _log_denom(f_k, u_kn, log_n_k) if log_denom is None else log_denom
    t = _masked((f_k[..., :, None] - u_kn).sub_(ld[..., None, :]), logm)
    return torch.expm1(_lse(t, group))


def _newton_state(f_k, u_kn, log_n_k, logm=None, log_denom=None, group=None):
    """Gradient (scaled), Hessian and the ``W~`` row sums in one pass."""
    ld = _log_denom(f_k, u_kn, log_n_k) if log_denom is None else log_denom
    n_k = torch.exp(log_n_k)
    w = _masked((f_k[..., :, None] - u_kn).sub_(ld[..., None, :]), logm).exp_()
    s_k = _sum(w, group)
    grad = n_k * (s_k - 1.0)
    g = _gram(w, group)  # (..., K, K)
    hess = torch.diag_embed(n_k * s_k) - (n_k[..., :, None] * n_k[..., None, :]) * g
    return grad, hess, s_k


def _newton_update(f_k, u_kn, log_n_k, logm=None, log_denom=None, group=None):
    """One gauge-fixed Newton step on the reduced coordinates ``f[1:]``."""
    grad, hess, _ = _newton_state(f_k, u_kn, log_n_k, logm, log_denom, group)
    k = f_k.shape[-1]
    h_red = hess[..., 1:, 1:]
    # the Tikhonov floor keeps the (K-1) x (K-1) solve sane if two states
    # coincide; at normal conditioning it is far below the Newton step
    floor = 1e-10 * torch.diagonal(h_red, dim1=-2, dim2=-1).sum(-1) / (k - 1)
    h_red = h_red + torch.eye(k - 1, dtype=f_k.dtype, device=f_k.device) * floor[..., None, None]
    # solve_ex: a singular system gives non-finite values (no host check),
    # and a non-finite Newton candidate loses to the fixed point
    delta = torch.linalg.solve_ex(h_red, grad[..., 1:, None])[0][..., 0]
    f_new = torch.cat([f_k[..., :1], f_k[..., 1:] + (-delta)], dim=-1)
    return f_new - f_new[..., :1]


def _max_abs_residual(f_k, u_kn, log_n_k, logm, log_denom, group=None):
    return _residual(f_k, u_kn, log_n_k, logm, log_denom, group).abs().amax(dim=-1)


def _solve(u_kn, log_n_k, logm, tol: float, max_iter: int, method: str, group=None):
    """Batched solve: ``log_n_k (B, K)``, ``logm (B, N)`` or None →
    ``(f (B, K), n_iter (B,), residual (B,))``.  A replicate stops where the
    reference's ``vmap``-ed ``while_loop`` stops it: its carry is frozen
    once its own condition fails, while the others go on.  With ``group``
    the samples are sharded over its ranks; every quantity the loop reads
    is all-reduced, so every rank stops on the same iteration."""
    b, k = log_n_k.shape
    f = torch.zeros((b, k), dtype=u_kn.dtype, device=u_kn.device)
    if method == "sci" or k < 2:
        f_prev = f
        f = _self_consistent_update(f, u_kn, log_n_k, logm, group=group)
        it = torch.ones(b, dtype=torch.int64, device=u_kn.device)
        MBAR_ITERS["n"] += 1
        while True:
            active = ((f - f_prev).abs().amax(dim=-1) > tol) & (it < max_iter)
            if not host_item(active.any()):  # one host read per iteration
                break
            f_new = _self_consistent_update(f, u_kn, log_n_k, logm, group=group)
            f_prev = torch.where(active[:, None], f, f_prev)
            f = torch.where(active[:, None], f_new, f)
            it = it + active
            MBAR_ITERS["n"] += 1
        return f, it, _max_abs_residual(f, u_kn, log_n_k, logm, None, group)

    if method != "hybrid":
        msg = f"unknown MBAR method {method!r} (use 'hybrid' or 'sci')"
        raise ValueError(msg)

    # the log denominator of the carried f rides along: it is the one the
    # chosen candidate's residual was computed with
    ld = _log_denom(f, u_kn, log_n_k)
    res = _max_abs_residual(f, u_kn, log_n_k, logm, ld, group)
    it = torch.zeros(b, dtype=torch.int64, device=u_kn.device)
    while True:
        active = (res > tol) & (it < max_iter)
        if not host_item(active.any()):  # one host read per iteration
            break
        f_new, ld_new, r_new = _hybrid_step(f, ld, u_kn, log_n_k, logm, group)
        keep = active[:, None]
        f = torch.where(keep, f_new, f)
        ld = torch.where(keep, ld_new, ld)
        res = torch.where(active, r_new, res)
        it = it + active
        MBAR_ITERS["n"] += 1
    return f, it, res


def _hybrid_step(f, ld, u_kn, log_n_k, logm=None, group=None):
    """One hybrid iteration from ``f (..., K)`` and its log denominator
    ``ld (..., N)``: the self-consistent and the Newton candidate, and of the
    two the one with the smaller residual, as ``(f, ld, residual)``."""
    f_sc = _self_consistent_update(f, u_kn, log_n_k, logm, ld, group)
    f_nw = _newton_update(f, u_kn, log_n_k, logm, ld, group)
    ld_sc = _log_denom(f_sc, u_kn, log_n_k)
    ld_nw = _log_denom(f_nw, u_kn, log_n_k)
    r_sc = _max_abs_residual(f_sc, u_kn, log_n_k, logm, ld_sc, group)
    r_nw = _max_abs_residual(f_nw, u_kn, log_n_k, logm, ld_nw, group)
    # a NaN Newton step (singular Hessian) loses every comparison
    take = torch.isfinite(r_nw) & (r_nw < r_sc)
    return (
        torch.where(take[..., None], f_nw, f_sc),
        torch.where(take[..., None], ld_nw, ld_sc),
        torch.where(take, r_nw, r_sc),
    )


def mbar_solve(u_kn, n_k, tol: float | None = None, max_iter: int = 10000, method: str = "hybrid", log_sample_weight=None):
    """Solve for dimensionless free energies ``f_k`` (gauge ``f_0 = 0``).

    ``u_kn``: reduced potentials ``(K, N)`` (every sample evaluated in every
    state); ``n_k``: samples drawn from each state ``(K,)``.

    ``method="hybrid"`` (default): each iteration computes the
    self-consistent and the Newton candidate and keeps the one with the
    smaller self-consistency residual (5-20 iterations where the plain fixed
    point needs hundreds).  ``method="sci"``: the plain fixed point,
    converged on ``max |Δf|``.  ``tol`` defaults to 1e-12 in float64 and
    1e-5 otherwise (float32 sums over N samples carry rounding noise).
    """
    f, _, _ = mbar_solve_info(u_kn, n_k, tol=tol, max_iter=max_iter, method=method, log_sample_weight=log_sample_weight)
    return f


def mbar_solve_info(u_kn, n_k, tol: float | None = None, max_iter: int = 10000, method: str = "hybrid", log_sample_weight=None):
    """Like :func:`mbar_solve` but returns ``(f_k, n_iter, residual)``:
    ``f_k`` and the final ``max |S_k - 1|`` as tensors on ``u_kn``'s
    device, the iteration count as a Python int (one counted read, as each
    iteration's).

    ``log_sample_weight (N,)``: a per-sample log weight added to every
    sample-axis reduction; ``-inf`` drops a sample (the mixture denominator
    still uses the given ``n_k``).
    """
    u_kn = _tensor(u_kn)
    log_n_k = torch.log(_tensor(n_k, u_kn.device, u_kn.dtype))
    logm = None if log_sample_weight is None else _tensor(log_sample_weight, u_kn.device, u_kn.dtype)[None]
    if tol is None:
        tol = 1e-12 if u_kn.dtype == torch.float64 else 1e-5
    f, it, res = _solve(u_kn, log_n_k[None], logm, tol, max_iter, method)
    return f[0], int(host_item(it[0])), res[0]


def _prep(u_kn, n_k, f_k):
    """``(u_kn, log n_k, f_k)`` as tensors of ``u_kn``'s type and device."""
    u_kn = _tensor(u_kn)
    return u_kn, torch.log(_tensor(n_k, u_kn.device, u_kn.dtype)), _tensor(f_k, u_kn.device, u_kn.dtype)


def mbar_log_weights(u_kn, n_k, f_k, u_target):
    """Log MBAR weights of each sample in a (possibly new) target state."""
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    logw = (_tensor(u_target, u_kn.device, u_kn.dtype) + _log_denom(f_k, u_kn, log_n_k)).neg_()
    return logw - torch.logsumexp(logw, dim=-1, keepdim=True)


def mbar_expectations(u_kn, n_k, f_k, u_target, x_n):
    """``<x>`` in the target state: ``x_n (N, V)`` → ``(V,)``."""
    w = mbar_log_weights(u_kn, n_k, f_k, u_target).exp_()
    x_n = _tensor(x_n, w.device, w.dtype)
    return _weighted_sums(w[None], _columns(x_n))[0].reshape(x_n.shape[1:])


def _grid_from_logw(logw, x_n, log_sample_weight=None, group=None):
    """Normalize the target log weights ``logw (..., A, N)`` (consumed in
    place) over the samples and contract them with ``x_n (N, *val)``:
    ``(..., A, *val)``."""
    if log_sample_weight is not None:
        logw.add_(log_sample_weight[..., None, :])
    logw.sub_(_lse(logw, group, keepdim=True)).exp_()
    out = _weighted_sums(logw.flatten(0, -2), _columns(x_n))
    if group is not None:
        dist.all_reduce(out, group=group)
    return out.reshape(logw.shape[:-1] + tuple(x_n.shape[1:]))


def _grid_from_denom(log_denom, u_targets, x_n, log_sample_weight=None, group=None):
    return _grid_from_logw((u_targets + log_denom[..., None, :]).neg_(), x_n, log_sample_weight, group)


def mbar_expectations_grid(u_kn, n_k, f_k, u_targets, x_n, log_sample_weight=None):
    """``<x>`` at many target states in one shot.

    ``u_targets``: reduced potentials of each target on all samples,
    ``(A, N)``; ``x_n``: ``(N, V)``.  Returns ``(A, V)``.  The mixture log
    denominator is computed once."""
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    u_targets = _tensor(u_targets, u_kn.device, u_kn.dtype)
    x_n = _tensor(x_n, u_kn.device, u_kn.dtype)
    lsw = None if log_sample_weight is None else _tensor(log_sample_weight, u_kn.device, u_kn.dtype)
    return _grid_from_denom(_log_denom(f_k, u_kn, log_n_k), u_targets, x_n, lsw)


def mbar_expectations_alphas(u_kn, n_k, f_k, alphas, u_base, x_n, chunk: int = 8, log_sample_weight=None):
    """``<x>`` at linear-in-α targets ``u_a(x_n) = α_a · u_base_n``.

    Unlike :func:`mbar_expectations_grid` the ``(A, N)`` target matrix is
    never built: the mixture log denominator is computed once, then the α
    are taken ``chunk`` at a time, each block a ``(chunk, N)`` temporary
    (three of them at the peak), so serving-scale N (1e8) with hundreds of
    targets fits on the card.  Returns ``(A, V)``.
    """
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    dev, dt = u_kn.device, u_kn.dtype
    alphas = _tensor(alphas, dev, dt)
    u_base = _tensor(u_base, dev, dt)
    x_n = _tensor(x_n, dev, dt)
    if x_n.ndim == 1:
        x_n = x_n[:, None]
    x_n = _columns(x_n)
    lsw = None if log_sample_weight is None else _tensor(log_sample_weight, dev, dt)
    ld = _log_denom(f_k, u_kn, log_n_k)
    a = alphas.shape[0]
    a_pad = torch.cat([alphas, alphas.new_zeros(-a % chunk)])
    # -(α u + ld) is the grid's -u_targets - ld to the bit
    out = [_grid_from_logw((blk[:, None] * u_base).add_(ld).neg_(), x_n, lsw) for blk in a_pad.reshape(-1, chunk)]
    return torch.cat(out)[:a]


# ---------------------------------------------------------------------------
# Uncertainties
# ---------------------------------------------------------------------------
#
# Two estimators, as in pymbar 4: the asymptotic covariance of the free
# energies (the svd-ew route), and a Poisson bootstrap of the expectations
# that solves the weighted MBAR problem once per replicate.


def _weights(u_kn, log_n_k, f_k, logm):
    """``W^T (K, N)``: the normalized weight of every sample in every state."""
    ld = _log_denom(f_k, u_kn, log_n_k)
    return _masked((f_k[:, None] - u_kn).sub_(ld[None, :]), logm).exp_()


def mbar_covariance(u_kn, n_k, f_k, log_sample_weight=None):
    """Asymptotic covariance ``Theta (K, K)`` of the ``f_k`` estimates, float64.

    ``Theta = V S (I - S V^T N V S)^+ S V^T`` where ``W^T W = V S^2 V^T``
    for the ``(N, K)`` weight matrix and ``N = diag(n_k)`` (Shirts & Chodera
    2008, Appendix D; pymbar's default).  ``W^T W`` is summed on ``u_kn``'s
    device in its type, and the ``K x K`` eigen-decomposition and
    pseudo-inverse run there too, in float64 (singular values below
    sqrt(eps) of ``u_kn``'s type of the largest are cut).  ``var(f_i - f_j) = Theta_ii
    + Theta_jj - 2 Theta_ij`` (:func:`mbar_fe_uncertainties`).
    """
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    logm = None if log_sample_weight is None else _tensor(log_sample_weight, u_kn.device, u_kn.dtype)
    o = _gram(_weights(u_kn, log_n_k, f_k, logm)).to(torch.float64)
    n_diag = _tensor(n_k, u_kn.device, torch.float64)
    evals, v = torch.linalg.eigh((o + o.T) / 2.0)
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    inner = torch.eye(s.shape[0], dtype=torch.float64, device=o.device) - s[:, None] * (v.T @ (n_diag[:, None] * v)) * s[None, :]
    # `inner` is singular (the gauge); its null singular value is rounding
    # noise of the solve, which numpy's 1e-15 cut-off of the reference keeps
    # now and then (and then divides by), so the cut-off here is sqrt(eps)
    # of the input type: an overlap eigenvalue that close to 1 is a
    # disconnected state either way
    rtol = torch.finfo(u_kn.dtype).eps ** 0.5
    return (v * s[None, :]) @ torch.linalg.pinv(inner, rtol=rtol) @ (s[:, None] * v.T)


def mbar_perturbed_free_energies(u_kn, n_k, f_k, u_targets, log_sample_weight=None):
    """Free energies of (possibly unsampled) target states, gauge ``f_0 = 0``:
    ``f_a = -log sum_n exp(-u_a(x_n) - log_denom_n)``, ``u_targets (A, N)``
    → ``(A,)``."""
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    u_targets = _tensor(u_targets, u_kn.device, u_kn.dtype)
    t = (u_targets + _log_denom(f_k, u_kn, log_n_k)[None, :]).neg_()
    if log_sample_weight is not None:
        t.add_(_tensor(log_sample_weight, u_kn.device, u_kn.dtype)[None, :])
    return -torch.logsumexp(t, dim=1)


def mbar_overlap(u_kn, n_k, f_k, log_sample_weight=None):
    """State-overlap matrix ``O_ij = N_j * sum_n W_ni W_nj`` ``(K, K)``:
    rows sum to 1, and ``min O`` near 0 flags a disconnected reweighting
    graph."""
    u_kn, log_n_k, f_k = _prep(u_kn, n_k, f_k)
    logm = None if log_sample_weight is None else _tensor(log_sample_weight, u_kn.device, u_kn.dtype)
    o = _gram(_weights(u_kn, log_n_k, f_k, logm))
    return o * _tensor(n_k, u_kn.device, u_kn.dtype)[None, :]


def mbar_fe_uncertainties(theta):
    """``d(f_i - f_j)`` matrix ``(K, K)`` from a covariance ``Theta``, as a
    numpy array (a tensor is copied to the host)."""
    theta = theta.detach().cpu().numpy() if isinstance(theta, torch.Tensor) else np.asarray(theta)
    d = np.diag(theta)
    var = d[:, None] + d[None, :] - 2.0 * theta
    return np.sqrt(np.clip(var, 0.0, None))


def _bootstrap_from_counts(u_kn, n_k, u_targets, x_n, counts, tol=None, max_iter: int = 1000, method: str = "hybrid"):
    """``<x>`` of each replicate at each target, ``(B, A, V)``, from the
    replicates' Poisson counts ``counts (B, N)`` (samples ordered state by
    state in blocks of ``n_k``).

    Each replicate's ``n_k`` is its count sum over each state's block (summed
    in float64, so that the sum is exact), its log sample weight ``log c``
    (``log 0 = -inf`` drops the sample), and its weighted MBAR problem is
    solved in one batched solve that freezes converged replicates; the
    target grid is then evaluated one replicate at a time.
    """
    sizes = [int(s) for s in n_k]
    n_rep = torch.stack([c.sum(dim=-1, dtype=torch.float64) for c in counts.split(sizes, dim=-1)], dim=-1)
    log_n_k = torch.log(n_rep.to(u_kn.dtype))
    logc = torch.log(counts)
    if tol is None:
        tol = 1e-12 if u_kn.dtype == torch.float64 else 1e-5
    f, _, _ = _solve(u_kn, log_n_k, logc, tol, max_iter, method)
    return torch.stack(
        [_grid_from_denom(_log_denom(f[i], u_kn, log_n_k[i]), u_targets, x_n, logc[i]) for i in range(counts.shape[0])]
    )


def mbar_bootstrap_expectations(
    u_kn,
    n_k,
    u_targets,
    x_n,
    nrep: int = 100,
    rng=None,
    tol: float | None = None,
    max_iter: int = 1000,
    method: str = "hybrid",
    rep_chunk: int = 2,
):
    """Poisson-bootstrap mean and std of ``<x>`` at each target state.

    Every replicate draws Poisson(1) counts ``c_n`` per sample
    (:func:`..ops.resample.poisson1_freq` from the generator of ``rng``: a
    ``torch.Generator``, a seed, or None for the default seed; one draw of N
    counts per replicate, so a replicate's counts do not depend on
    ``rep_chunk``) and solves the weighted MBAR problem, counts as log
    sample weights and per-state count sums as ``n_k``; then evaluates the
    target grid.  ``rep_chunk`` replicates are solved together, so the
    ``(nrep, N)`` count table never exists.

    Memory: a chunk of B replicates holds at its peak about ``(7 + 2K) B N``
    numbers of ``u_kn``'s type beside ``u_kn`` and ``u_targets`` (counts and
    their logs, five log denominators, two ``(B, K, N)`` blocks): at K = 3,
    N = 1e8 in float32, 5.2 GB a replicate, 10.4 GB at the default
    ``rep_chunk = 2``.  Replicates cost the same time alone or together (the
    work is bound by memory traffic), so ``rep_chunk`` only trades memory
    for Python loop trips.

    ``n_k`` gives the per-state contiguous sample blocks (samples ordered
    state by state, as :class:`.extrap.MBARModel` pools them).  Returns
    ``(mean, std)``, each ``(A, V)``.
    """
    u_kn = _tensor(u_kn)
    dev, dt = u_kn.device, u_kn.dtype
    u_targets = _tensor(u_targets, dev, dt)
    x_n = _tensor(x_n, dev, dt)
    if x_n.ndim == 1:
        x_n = x_n[:, None]
    x_n = _columns(x_n)
    gen = validate_rng(rng, device=dev)
    n_k = n_k.tolist() if isinstance(n_k, torch.Tensor) else np.asarray(n_k, dtype=np.int64).tolist()
    n = u_kn.shape[1]
    outs = []
    for start in range(0, nrep, rep_chunk):
        counts = torch.stack(
            [poisson1_freq(gen, (n,), dtype=dt, device=dev) for _ in range(min(rep_chunk, nrep - start))]
        )
        outs.append(_bootstrap_from_counts(u_kn, n_k, u_targets, x_n, counts, tol, max_iter, method))
        del counts
    out = torch.cat(outs)
    return out.mean(dim=0), out.std(dim=0, correction=1)


def statistical_inefficiency(x, y=None, mintime: int = 3):
    """Integrated (cross-)correlation time estimator ``g = 1 + 2 sum C(t)``.

    FFT autocorrelation (``torch.fft``) with positive-sequence truncation,
    the replacement for ``pymbar.timeseries.statistical_inefficiency``.
    With ``y`` the cross statistical inefficiency from the symmetrized
    cross-correlation ``(<dx(0)dy(t)> + <dy(0)dx(t)>)/2``, normalized by
    ``<dx dy>``.  float64 input is computed in float64, any other in
    float32; returns a 0-d tensor on ``x``'s device.

    Examples
    --------
    >>> import numpy as np
    >>> rng = np.random.default_rng(0)
    >>> white = rng.normal(size=4000)
    >>> float(statistical_inefficiency(white)) < 1.3  # iid data: g ~ 1
    True
    >>> ar = np.empty(4000)  # AR(1), rho=0.9: g ~ (1+rho)/(1-rho) = 19
    >>> ar[0] = 0.0
    >>> for t in range(1, 4000):
    ...     ar[t] = 0.9 * ar[t - 1] + rng.normal()
    >>> 8.0 < float(statistical_inefficiency(ar)) < 40.0
    True
    """
    x = _tensor(x)
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    n = x.shape[0]
    dx = x - x.mean()
    nfft = 2 * n
    f = torch.fft.rfft(dx, n=nfft)
    if y is None:
        spec = f * torch.conj(f)
    else:
        y = _tensor(y, x.device, x.dtype)
        fy = torch.fft.rfft(y - y.mean(), n=nfft)
        # symmetrized cross spectrum: (xy + yx)/2 is real for real series
        spec = 0.5 * (f * torch.conj(fy) + fy * torch.conj(f))
    acf = torch.fft.irfft(spec, n=nfft)[:n]
    acf0 = acf[0]
    nonzero = acf0.abs() > 0
    acf = acf / torch.where(nonzero, acf0, torch.ones_like(acf0))
    t = torch.arange(n, dtype=x.dtype, device=x.device)
    c_t = acf / ((n - t) / n)
    # count 2 (1 - t/n) C(t) while C(t) > 0 (always before mintime); the
    # cumulative product stops the sum at the first negative C(t)
    alive = torch.cumprod(((c_t > 0) | (t < mintime)).to(x.dtype), dim=0)
    g = 1.0 + 2.0 * torch.sum(alive[1:] * c_t[1:] * (1.0 - t[1:] / n))
    # degenerate cross-covariance (<dx dy> == 0): no decorrelation signal
    g = torch.where(nonzero, g, torch.ones_like(g))
    return torch.clamp(g, min=1.0)


def subsample_correlated_data(x, g=None):
    """Indices of an effectively uncorrelated subsample (a host helper:
    returns numpy indices)."""
    if g is None:
        g = float(statistical_inefficiency(x))
    stride = max(int(np.ceil(g)), 1)
    return np.arange(0, len(x), stride)

"""Plain float64 reference of derivative-informed heteroscedastic GPR on
sampled states, after upstream thermoextrap v0.6.0's ``gpr_active``
(``active_utils.input_GP_from_state`` and ``create_GPR``, with
``gp_models.HeteroscedasticGPR`` and the RBF derivative kernel).  It imports
nothing of the program.

Each state ``k`` at ``beta_k`` gives the rows ``(beta_k, n)``, ``n = 0 ..
order``, of the GP's inputs:

- ``y``: the ``n``-th β derivative of ``<x>`` from the float32 samples the
  benchmark made, by weighted power sums about a fixed shift in float64
  over blocks of samples, the central (co)moments and the Taylor series of
  ``reference/series.py`` (derivative ``n`` = ``n!`` times coefficient
  ``n``);
- its noise: the covariance (``np.cov``, over replicates) of the same
  derivatives on ``boot_nrep`` bootstrap replicates, whose counts come from
  the index table the program draws (``torch.randint(0, R, (nrep, R))`` on
  the samples' device from one generator seeded with ``table_seed``, one
  table a state in turn), drawn here again bit for bit and counted.

The noise of the stacked rows is the block diagonal of the states'
covariances.  The GP (upstream's ``create_base_GP_model`` and
``HeteroscedasticGPR``):

- mean: the least-squares line through the order-0 rows at order 0, its
  slope at order 1, zero above (``LinearWithDerivs``);
- output scale: the deviation (``ddof`` 0) of the order-0 rows about it;
  the data, mean and noise are divided by it (its square for the noise);
- kernel: ``d^a_{x1} d^b_{x2}`` of ``var exp(-(x1 - x2)^2 / (2 l^2))``,
  ``var l^-(a+b) (-1)^a He_{a+b}(z) exp(-z^2 / 2)`` with ``z = (x1 - x2) /
  l`` and ``He`` the probabilists' Hermite polynomials;
- noise: ``S cov S`` with ``S = diag(exp(p (n_i + 1) + s / 2))``, plus
  ``1e-12`` on the diagonal; ``s = 0`` is fixed;
- parameters: ``l``, ``var`` (start 1) and ``p`` (start 10), each
  ``softplus(raw) + 1e-6`` of an unconstrained ``raw``;
- fit: scipy's L-BFGS-B on the negative log marginal likelihood and its
  autograd gradient, from the same start with the same options
  (``maxiter`` 1000); a point where the Cholesky factor fails reads
  ``1e12`` with a zero gradient; the fitted point is kept where it is no
  worse than the start;
- answer: the posterior mean of ``<x>`` at each target and the log of its
  deviation, times ``log_sigma_weight``.  ``pred_err`` divides every gap
  by the mean's change over the targets, so the deviation is held by its
  relative error: a gap ``r`` in ``ln sigma`` reads ``log_sigma_weight * r``
  over that change (the deviation itself, ~1e-5 of the change at the
  cell's size, would read as nothing), and a deviation of 0 reads as not
  finite.

Departures from upstream: the positive transform is ``log(1 + e^x) +
1e-6`` evaluated as ``logaddexp(x, 0)`` (GPflow's softplus switches to the
identity above 20), and the gradient comes from torch's autograd, not
TensorFlow's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import series

BLOCK = 1 << 20  # samples a block of the power sums
_HEAD = 8192  # samples behind the shift
SHIFT = 1e-6  # the positive transform's floor
JITTER = 1e-12  # the noise diagonal's floor
START = {"l": 1.0, "var": 1.0, "p": 10.0}
MAXITER = 1000
FAILED = 1e12  # the objective where the Cholesky factor fails


def _powers(u, x, su: float, sx: float, order: int):
    du = u.double() - su
    p = torch.stack([du**k for k in range(order + 1)], dim=1)  # (n, order+1)
    return p, p * (x.double() - sx)[:, None]


def _derivs(sums_u, sums_x, su: float, sx: float, order: int):
    """β derivatives of ``<x>`` ``(order+1, ...)`` from power sums."""
    _d, du, dx_off, dxdu = series.central(sums_u, sums_x, order)
    coefs = series.x_ave_coefs(sx + dx_off, du, dxdu, order)
    fact = torch.tensor([math.factorial(n) for n in range(order + 1)], dtype=torch.float64, device=coefs.device)
    return coefs * fact.reshape((-1,) + (1,) * (coefs.ndim - 1))


def state_inputs(u, x, order: int, idx):
    """``(y (order+1,), cov (order+1, order+1))`` of one state's samples
    ``u, x (R,)``; ``idx (nrep, R)`` its bootstrap index table."""
    r = u.shape[0]
    su, sx = float(u[:_HEAD].double().mean()), float(x[:_HEAD].double().mean())
    counts = torch.zeros(idx.shape, dtype=torch.int32, device=u.device)
    for i in range(idx.shape[0]):
        counts[i] = torch.bincount(idx[i], minlength=r)
    acc = [0.0, 0.0, 0.0, 0.0]  # point sums of u and x, replicate sums of u and x
    for s in range(0, r, BLOCK):
        p, px = _powers(u[s : s + BLOCK], x[s : s + BLOCK], su, sx, order)
        f = counts[:, s : s + BLOCK].double()
        for j, v in enumerate((p.sum(0), px.sum(0), f @ p, f @ px)):
            acc[j] = acc[j] + v
    del counts
    y = _derivs(acc[0], acc[1], su, sx, order).cpu().numpy()
    boot = _derivs(acc[2], acc[3], su, sx, order).cpu().numpy()  # (order+1, nrep)
    return y, np.cov(boot)


def _block_diag(blocks):
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n))
    i = 0
    for b in blocks:
        out[i : i + b.shape[0], i : i + b.shape[0]] = b
        i += b.shape[0]
    return out


def _softplus(raw):
    return torch.logaddexp(raw, torch.zeros_like(raw)) + SHIFT


def _inv_softplus(v: float) -> float:
    return math.log(math.expm1(v - SHIFT))


def rbf_deriv(x1, a, x2, b, ell, var):
    """The RBF kernel's mixed partials at every pair: ``(len(x1), len(x2))``."""
    z = (x1[:, None] - x2[None, :]) / ell
    n = (a[:, None] + b[None, :]).long()
    he = [torch.ones_like(z), z]
    for k in range(1, int(n.max()) + 1):
        he.append(z * he[k] - k * he[k - 1])
    he_n = torch.gather(torch.stack(he), 0, n[None])[0]
    sign = (-1.0) ** a[:, None]
    return var * ell ** (-(a[:, None] + b[None, :])) * sign * he_n * torch.exp(-0.5 * z * z)


class GP:
    """The scaled GP data of the stacked states and its marginal
    likelihood, posterior and fit."""

    def __init__(self, locs, orders, y, cov):
        self.locs, self.orders = (torch.as_tensor(a, dtype=torch.float64) for a in (locs, orders))
        zero = orders == 0
        design = np.column_stack([np.ones(zero.sum()), locs[zero]])
        (self.icept, self.slope), *_ = np.linalg.lstsq(design, y[zero], rcond=None)
        resid = y[zero] - self._mean_np(locs[zero], orders[zero])
        sd = float(np.std(resid)) if len(np.unique(locs[zero])) > 1 else 1.0
        self.scale = sd if sd > 0 else 1.0
        self.y = torch.as_tensor(y / self.scale)
        self.cov = torch.as_tensor(cov / self.scale**2)
        self.mean = torch.as_tensor(self._mean_np(locs, orders) / self.scale)
        self.dplus = self.orders + 1.0

    def _mean_np(self, locs, orders):
        return np.where(orders == 0, self.icept + self.slope * locs, np.where(orders == 1, self.slope, 0.0))

    def _factor(self, raw):
        ell, var, p = _softplus(raw)
        k = rbf_deriv(self.locs, self.orders, self.locs, self.orders, ell, var)
        s = torch.exp(p * self.dplus)
        ks = k + s[:, None] * self.cov * s[None, :] + JITTER * torch.eye(len(self.y), dtype=torch.float64)
        chol, info = torch.linalg.cholesky_ex(0.5 * (ks + ks.T))
        return chol, int(info), ell, var

    def neg_lml(self, raw):
        chol, info, _ell, _var = self._factor(raw)
        alpha = torch.linalg.solve_triangular(chol, (self.y - self.mean)[:, None], upper=False)[:, 0]
        n = len(self.y)
        lml = -0.5 * alpha @ alpha - 0.5 * n * math.log(2.0 * math.pi) - torch.log(torch.diagonal(chol)).sum()
        return -lml, info

    def objective(self, raw_np):
        """``(value, gradient)`` for scipy; ``FAILED`` and zeros where the
        factor fails or a number is not finite."""
        with torch.enable_grad():  # the harness checks under no_grad
            raw = torch.tensor(raw_np, dtype=torch.float64, requires_grad=True)
            val, info = self.neg_lml(raw)
            if info != 0 or not torch.isfinite(val):
                return FAILED, np.zeros_like(raw_np)
            (grad,) = torch.autograd.grad(val, raw)
        g = grad.numpy()
        if not np.all(np.isfinite(g)):
            return FAILED, np.zeros_like(raw_np)
        return float(val.detach()), g

    def fit(self):
        """The unconstrained parameters after the L-BFGS-B fit."""
        from scipy import optimize

        x0 = np.array([_inv_softplus(START[k]) for k in ("l", "var", "p")])
        f0, _ = self.objective(x0)
        res = optimize.minimize(self.objective, x0, jac=True, method="L-BFGS-B", options={"maxiter": MAXITER})
        f1, _ = self.objective(np.asarray(res.x, dtype=np.float64))
        return res.x if np.isfinite(f1) and f1 <= f0 else x0

    def posterior(self, raw_np, betas):
        """Posterior mean and deviation of the order-0 observable at ``betas``."""
        with torch.no_grad():
            raw = torch.as_tensor(raw_np, dtype=torch.float64)
            chol, _info, ell, var = self._factor(raw)
            b = torch.as_tensor(betas, dtype=torch.float64)
            b0 = torch.zeros_like(b)
            kmn = rbf_deriv(self.locs, self.orders, b, b0, ell, var)
            a = torch.linalg.solve_triangular(chol, kmn, upper=False)
            w = torch.linalg.solve_triangular(chol, (self.y - self.mean)[:, None], upper=False)[:, 0]
            mean = (a.T @ w + torch.as_tensor(self._mean_np(b.numpy(), b0.numpy())) / self.scale) * self.scale
            kdiag = torch.diagonal(rbf_deriv(b, b0, b, b0, ell, var))
            var_post = (kdiag - (a * a).sum(0)) * self.scale**2
        return mean, var_post


def staged(cfg: dict, inputs: dict):
    """The stacked GP inputs ``(locs, orders, y, cov)`` of every state."""
    u, x = inputs["u"], inputs["x"]
    k, r = u.shape
    order, nrep = int(cfg["order"]), int(cfg["boot_nrep"])
    gen = torch.Generator(device=u.device)
    gen.manual_seed(int(cfg["table_seed"]))
    ys, covs = [], []
    for i in range(k):
        idx = torch.randint(0, r, (nrep, r), generator=gen, device=u.device)
        y, cov = state_inputs(u[i], x[i], order, idx)
        del idx
        ys.append(y)
        covs.append(cov)
    betas0 = np.asarray(cfg["state_betas"], dtype=np.float64)
    locs = np.repeat(betas0, order + 1)
    orders = np.tile(np.arange(order + 1, dtype=np.float64), k)
    return locs, orders, np.concatenate(ys), _block_diag(covs)


def predict(cfg: dict, inputs: dict, betas) -> dict:
    """``{"pred" (A, 2), "std": None, "c0" (2,)}``: the posterior mean of
    ``<x>`` at each target and ``log_sigma_weight`` times the log of its
    deviation; ``c0`` is the first target's."""
    gp = GP(*staged(cfg, inputs))
    mean, var = gp.posterior(gp.fit(), np.asarray(betas, dtype=np.float64))
    pred = torch.stack([mean, float(cfg["log_sigma_weight"]) * 0.5 * torch.log(var)], dim=1)
    return {"pred": pred, "std": None, "c0": pred[0]}

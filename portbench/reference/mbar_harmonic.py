"""Plain float64 reference of MBAR reweighting of pooled harmonic-oscillator
samples to many target states.  It imports nothing of the program.

State ``k`` has the reduced potential ``u_k(x) = alpha_k x^2 / 2`` with
``alpha_k = 1 / sigma_k^2``, and ``R`` samples of each state are pooled.
``predict`` first solves Shirts & Chodera's self-consistent equations

    f_k = -log sum_n exp(-u_k(x_n)) / sum_j R exp(f_j - u_j(x_n))

by their plain fixed-point iteration (gauge ``f_0 = 0``) until no ``f_k``
moves by more than ``TOL``, then gives each target ``alpha_a`` the
normalised weights ``exp(-alpha_a x_n^2 / 2) / sum_j R exp(f_j - u_j(x_n))``
and their averages of ``(x, x^2)``.  Every sum over the samples runs in
blocks; the targets' sums keep a running maximum per target (an online
log-sum-exp), so no ``(A, N)`` matrix is built.
"""

from __future__ import annotations

import math

import torch

TOL = 1e-10
MAX_ITER = 100_000
SOLVE_BLOCK = 1 << 23  # samples a block of the solve
GRID_ELEMS = 1 << 27  # targets x samples a block of the targets' sums


def sigmas(lo: float, hi: float, n: int) -> torch.Tensor:
    return torch.linspace(float(lo), float(hi), int(n), dtype=torch.float64)


def state_alphas(cfg: dict) -> torch.Tensor:
    """``alpha_k = 1 / sigma_k^2`` of the configuration's sampled states."""
    return sigmas(*cfg["sigma_range"], cfg["states"]) ** -2


def _blocks(n: int, size: int):
    return [(s, min(size, n - s)) for s in range(0, n, size)]


def _log_denom(f, alpha0, log_r: float, u):
    """``log sum_j R exp(f_j - alpha_j u_n)`` of a block of samples ``u``."""
    return torch.logsumexp((f + log_r)[:, None] - alpha0[:, None] * u[None, :], dim=0)


def solve(u, alpha0, log_r: float):
    """Free energies ``f (K,)`` of the states on the pooled samples ``u (N,)``
    and the iterations taken."""
    f = torch.zeros_like(alpha0)
    spans = _blocks(u.shape[0], SOLVE_BLOCK)
    for it in range(1, MAX_ITER + 1):
        acc = torch.full_like(alpha0, -math.inf)
        for s, n in spans:
            ub = u[s : s + n]
            t = -(alpha0[:, None] * ub[None, :]) - _log_denom(f, alpha0, log_r, ub)[None, :]
            acc = torch.logaddexp(acc, torch.logsumexp(t, dim=1))
        f_new = -acc
        f_new = f_new - f_new[0]
        step = float((f_new - f).abs().max())
        f = f_new
        if step <= TOL:
            return f, it
    msg = f"the self-consistent iteration moved {step:.3g} after {MAX_ITER} iterations"
    raise RuntimeError(msg)


def predict(cfg: dict, inputs: dict, alphas) -> dict:
    """``{"pred" (A, 2), "std": None, "c0" (2,)}``: ``<x>`` and ``<x^2>`` at
    each target ``alphas[a]``; ``c0`` is the first target's."""
    x = inputs["x"]  # (K, R), state by state
    k, r = x.shape
    alpha0 = state_alphas(cfg).to(x.device)
    log_r = math.log(r)
    xs = x.reshape(-1).double()
    u = 0.5 * xs * xs
    f, _ = solve(u, alpha0, log_r)
    alphas = torch.as_tensor(alphas, dtype=torch.float64, device=x.device)
    nb = max(1, GRID_ELEMS // alphas.shape[0])
    top = torch.full_like(alphas, -math.inf)  # each target's running maximum log weight
    sums = torch.zeros((alphas.shape[0], 3), dtype=torch.float64, device=x.device)  # (1, x, x^2)
    for s, n in _blocks(u.shape[0], nb):
        ub, xb = u[s : s + n], xs[s : s + n]
        logw = -(alphas[:, None] * ub[None, :]) - _log_denom(f, alpha0, log_r, ub)[None, :]
        new_top = torch.maximum(top, logw.amax(dim=1))
        sums *= torch.exp(top - new_top)[:, None]
        top = new_top
        w = torch.exp(logw - top[:, None])
        sums += w @ torch.stack([torch.ones_like(xb), xb, xb * xb], dim=1)
    pred = sums[:, 1:] / sums[:, :1]
    return {"pred": pred, "std": None, "c0": pred[0]}

"""The weighted MBAR solve of the Poisson bootstrap at its iteration cap, in
both packages on the same counts.

``MBARModel.predict_ci`` solves each replicate's MBAR problem with its
Poisson counts as log sample weights and ``max_iter=1000``
(``thermoextrap_tpu/models/mbar.py:160`` and the port's ``mbar_solve_info``,
reached through ``_bootstrap_from_counts``).  That solve converges far more
slowly than the unweighted one.  The tests hold the port to the JAX package
at a cap and after convergence; run as a script, this file measures what
the cap does to the bootstrap σ at ``2e4 x 200`` samples a state::

    python tests/test_torch_mbar_cap.py [--reps 16] [--procs 4]

It prints one JSON line: each replicate's iterations and residual at the cap
in both packages, the largest ``|f|`` difference between them, the
iterations to convergence, and the σ of ``<x>`` at the targets at the cap
and converged.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script: the repository's packages and the parity helper
    sys.path[:0] = [str(Path(__file__).resolve().parent.parent), str(Path(__file__).resolve().parent)]

from _torch_parity import npy  # noqa: E402  (pins the default device to the CPU)

from thermoextrap_tpu_torch import idealgas  # noqa: E402
from thermoextrap_tpu_torch.models import mbar as tm  # noqa: E402

BETAS = (0.5, 1.0, 2.0, 4.0)  # examples/mbar_reweighting.py's states
TARGETS = tuple(np.linspace(0.5, 4.0, 8))
CAP = 1000  # the bootstrap's max_iter
CONVERGED = 100_000


def problem(nconfig: int, npart: int):
    """``(u_kn, uv, xv)`` of the pooled ideal-gas states (float64, CPU)."""
    xs, us = zip(*(idealgas.generate_data((nconfig, npart), b, rng=i, device="cpu") for i, b in enumerate(BETAS)))
    uv, xv = torch.cat(us), torch.cat(xs)
    return torch.tensor(BETAS, dtype=torch.float64)[:, None] * uv[None], uv, xv


def counts(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).poisson(1.0, n).astype(np.float64)


def solve_both(u_kn, nconfig: int, c: np.ndarray, max_iter: int):
    """The replicate's weighted solve in each package: ``((f, it, res) JAX, (f, it, res) port)``."""
    from thermoextrap_tpu.models import mbar as jm

    n_k = c.reshape(len(BETAS), nconfig).sum(axis=1)
    with np.errstate(divide="ignore"):
        lw = np.log(c)
    fj, ij, rj = jm.mbar_solve_info(npy(u_kn), n_k, max_iter=max_iter, log_sample_weight=lw)
    ft, it, rt = tm.mbar_solve_info(u_kn, n_k, max_iter=max_iter, log_sample_weight=torch.tensor(lw))
    return (np.asarray(fj), int(ij), float(rj)), (npy(ft), it, float(rt))


def expectations(u_kn, uv, xv, nconfig: int, c: np.ndarray, f) -> np.ndarray:
    """The replicate's ``<x>`` at the targets from its free energies ``f``."""
    n_k = torch.tensor(c.reshape(len(BETAS), nconfig).sum(axis=1))
    with np.errstate(divide="ignore"):
        lw = torch.tensor(np.log(c))
    denom = tm._log_denom(torch.as_tensor(f), u_kn, torch.log(n_k))
    u_t = torch.tensor(TARGETS, dtype=torch.float64)[:, None] * uv[None]
    return npy(tm._grid_from_denom(denom, u_t, xv[:, None], lw))[:, 0]


@pytest.fixture(scope="module")
def small():
    return problem(300, 20)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_solve_equals_the_reference_at_a_cap(small, seed):
    u_kn, _, _ = small
    c = counts(u_kn.shape[1], seed)
    (fj, ij, rj), (ft, it, rt) = solve_both(u_kn, 300, c, max_iter=8)
    assert ij == it == 8 and rj > 1e-12 and rt > 1e-12  # stopped by the cap
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt, rj, rtol=1e-6)


def test_weighted_solve_equals_the_reference_converged(small):
    u_kn, uv, xv = small
    c = counts(u_kn.shape[1], 2)
    (fj, ij, rj), (ft, it, rt) = solve_both(u_kn, 300, c, max_iter=CONVERGED)
    assert ij == it < CONVERGED and rj <= 1e-12 and rt <= 1e-12
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-9)
    x = expectations(u_kn, uv, xv, 300, c, ft)
    assert np.all(np.isfinite(x)) and x.shape == (len(TARGETS),)


def _replicate(args):
    nconfig, npart, seed = args
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    u_kn, uv, xv = problem(nconfig, npart)
    c = counts(u_kn.shape[1], seed)
    (fj, ij, rj), (ft, it, rt) = solve_both(u_kn, nconfig, c, max_iter=CAP)
    with np.errstate(divide="ignore"):
        lw = torch.tensor(np.log(c))
    f_conv, i_conv, r_conv = tm.mbar_solve_info(
        u_kn, c.reshape(len(BETAS), nconfig).sum(axis=1), max_iter=CONVERGED, log_sample_weight=lw
    )
    return {
        "seed": seed,
        "cap": {"jax": [ij, rj], "port": [it, rt]},
        "max_abs_df_jax_port_at_cap": float(np.abs(fj - ft).max()),
        "converged": [i_conv, float(r_conv)],
        "f_cap": ft.tolist(),
        "f_converged": npy(f_conv).tolist(),
        "x_cap": expectations(u_kn, uv, xv, nconfig, c, ft).tolist(),
        "x_converged": expectations(u_kn, uv, xv, nconfig, c, f_conv).tolist(),
    }


def main(argv: list[str]) -> None:
    import argparse
    import multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--nconfig", type=int, default=20_000)
    ap.add_argument("--npart", type=int, default=200)
    a = ap.parse_args(argv)
    with mp.get_context("spawn").Pool(a.procs) as pool:
        reps = pool.map(_replicate, [(a.nconfig, a.npart, s) for s in range(a.reps)])
    x_cap = np.array([r["x_cap"] for r in reps])
    x_conv = np.array([r["x_converged"] for r in reps])
    s_cap, s_conv = x_cap.std(axis=0, ddof=1), x_conv.std(axis=0, ddof=1)
    print(json.dumps({
        "states": list(BETAS), "nconfig": a.nconfig, "npart": a.npart, "reps": a.reps, "targets": list(TARGETS),
        "iterations_to_converge": [r["converged"][0] for r in reps],
        "residual_at_cap": [r["cap"]["port"][1] for r in reps],
        "same_iterations_and_residual_at_cap": all(r["cap"]["jax"][0] == r["cap"]["port"][0] for r in reps),
        "max_abs_df_jax_port_at_cap": max(r["max_abs_df_jax_port_at_cap"] for r in reps),
        "max_abs_df_cap_vs_converged": max(np.abs(np.subtract(r["f_cap"], r["f_converged"])).max() for r in reps),
        "max_abs_dx_cap_vs_converged": float(np.abs(x_cap - x_conv).max()),
        "sigma_cap": s_cap.tolist(),
        "sigma_converged": s_conv.tolist(),
        "sigma_rel_err": ((s_cap - s_conv) / s_conv).tolist(),
    }))


if __name__ == "__main__":
    main(sys.argv[1:])

"""One-call serving pipelines: extrapolation + CI, lnPi grids, volume and
perturbation, on the port.

The PyTorch form of ``examples/serving_pipeline.py``: the whole chain (moment
reduction -> series derivative engine -> Taylor evaluation -> Poisson
bootstrap CI) behind one call.  On the card the reduction is K1 and the
bootstrap draws its Poisson(1) counts inside K3 (no count table); the lnPi
grid takes the batched u-moment kernels K4 and K5, the volume pipeline K1 and
K3, and the perturbation pipeline K8.  The reference's ``jax.random`` draws
are torch draws from an explicit ``torch.Generator`` on the default device.

Run: python examples_torch/serving_pipeline.py          (CUDA card, R=1e5 x 1e3, grid 512 x 1e6)
     python examples_torch/serving_pipeline.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import time

import numpy as np
import torch

from thermoextrap_tpu_torch import default_device, idealgas, volume
from thermoextrap_tpu_torch.pipeline import (
    make_extrap_pipeline,
    make_lnpi_pipeline,
    make_perturb_pipeline,
    make_volume_pipeline,
)


def _timed(fn):
    """``(result, seconds)`` of one call, waiting for the card."""
    dev = default_device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(smoke: bool = SMOKE) -> dict:
    dev = default_device()
    beta0, order = 2.0, 4
    nconfig, npart = (2_000, 100) if smoke else (100_000, 1_000)
    nrep = 32 if smoke else 128

    # ideal-gas samples at beta0 (float32 streams); predictions vs the analytic answer
    x, u = idealgas.generate_data((nconfig, npart), beta0, rng=0, dtype=torch.float32)
    betas = torch.tensor([1.6, 1.8, 2.0, 2.2, 2.4], dtype=torch.float64, device=dev)

    run_ = make_extrap_pipeline(order, beta0, nrep=nrep)
    run_(u, x, betas, seed=0)  # first call (on the card: builds or loads the kernels)
    (pred, std), dt = _timed(lambda: run_(u, x, betas, seed=1))

    exact = np.array([float(idealgas.x_ave(float(b))) for b in betas])
    pred_n, std_n = pred.reshape(-1).cpu().numpy(), std.reshape(-1).cpu().numpy()
    # generate_data returns per-configuration aggregates: the reduction
    # runs over nconfig records (each summarizing npart particles)
    print(f"one-call extrap+CI ({u.shape[0]:.0e} config records, {nrep} bootstrap reps): {dt * 1e3:.1f} ms")
    for b, p, s, e in zip(betas.tolist(), pred_n, std_n, exact):
        print(f"  beta={b:.1f}: pred={p:.6f} +/- {s:.1e}  analytic={e:.6f}")
    err = np.abs(pred_n - exact)
    if not err[2] < 1e-3:
        raise SystemExit(f"beta0 prediction off the analytic <x> by {err[2]:.2e}")

    # bf16 sample streams: half the memory traffic per serving call (only
    # engages on the card)
    run16 = make_extrap_pipeline(order, beta0, nrep=nrep, bf16=True)
    run16(u, x, betas, seed=0)
    (p16, _s16), dt16 = _timed(lambda: run16(u, x, betas, seed=1))
    bf16_diff = float((p16.reshape(-1).cpu() - pred.reshape(-1).cpu()).abs().max())
    print(f"  bf16 streams: {dt16 * 1e3:.1f} ms; max |bf16 - f32| = {bf16_diff:.1e}")
    if not bf16_diff < 5e-2:
        raise SystemExit(f"bf16 streams off the float32 ones by {bf16_diff:.2e}")

    # lnPi macrostate grid in one call
    n_grid, r = (16, 5_000) if smoke else (512, 1_000_000)
    gen = torch.Generator(device=dev).manual_seed(7)
    shift = torch.linspace(-2.0, 2.0, n_grid, device=dev)
    uvg = shift[:, None] + (-10.0 + 1.5 * torch.randn((n_grid, r), generator=gen, device=dev, dtype=torch.float32))
    lnpi0 = torch.linspace(0.0, 5.0, n_grid, device=dev)
    mudotn = 0.7 * torch.arange(n_grid, dtype=torch.float32, device=dev)
    gbetas = torch.tensor([1.2, 1.4, 1.6], device=dev)

    run_lnpi = make_lnpi_pipeline(3, 1.4)
    run_lnpi(uvg, lnpi0, mudotn, gbetas)
    out, dt = _timed(lambda: run_lnpi(uvg, lnpi0, mudotn, gbetas))
    np.testing.assert_allclose(out[1].cpu().numpy(), lnpi0.cpu().numpy(), rtol=1e-4, atol=1e-4)
    print(f"one-call lnPi grid ({n_grid} macrostates x {r:.0e} samples): {dt * 1e3:.1f} ms")

    # ... with a bootstrap CI over the whole grid (shared-count replicates:
    # on the card the batched in-kernel Poisson bootstrap, no count table)
    nrep_g = 16 if smoke else 64
    run_lnpi_ci = make_lnpi_pipeline(3, 1.4, nrep=nrep_g)
    gb2 = torch.tensor([1.2, 1.6], device=dev)
    run_lnpi_ci(uvg, lnpi0, mudotn, gb2, seed=2)
    (gp, gs), dt = _timed(lambda: run_lnpi_ci(uvg, lnpi0, mudotn, gb2, seed=3))
    gs = gs.cpu().numpy()
    if not (gs.shape == (2, n_grid) and np.all(gs >= 0)):
        raise SystemExit(f"grid bootstrap CI of shape {gs.shape} with a negative entry")
    print(f"  + grid bootstrap CI ({nrep_g} reps): {dt * 1e3:.1f} ms; median std {np.median(gs):.2e}")
    del uvg

    # --- volume ensemble: one packed order-1 reduction serves
    # d<x>/dV = (cov(x, W) + <dxdq>) / (V d) with a bootstrap CI
    rv = 20_000 if smoke else 10_000_000
    v0, nd = 2.0, 3
    rng = np.random.default_rng(4)
    wv = torch.as_tensor(rng.normal(1.0, 0.4, rv), dtype=torch.float32, device=dev)
    xvv = 0.5 + 0.3 * wv + torch.as_tensor(rng.normal(0, 0.2, rv), dtype=torch.float32, device=dev)
    dxdqv = 0.1 * xvv + torch.as_tensor(rng.normal(0, 0.05, rv), dtype=torch.float32, device=dev)
    vols = torch.tensor([1.8, 2.0, 2.3], dtype=torch.float32, device=dev)

    run_vol = make_volume_pipeline(v0, ndim=nd, nrep=nrep)
    run_vol(wv, xvv, dxdqv, vols, seed=5)
    (vp, vs), dt = _timed(lambda: run_vol(wv, xvv, dxdqv, vols, seed=6))
    model = volume.factory_extrapmodel(v0, wv, xvv, dxdqv, ndim=nd)
    np.testing.assert_allclose(vp.reshape(-1).cpu().numpy(), model.predict(vols).reshape(-1).cpu().numpy(), rtol=5e-3)
    if not bool((vs > 0).all()):
        raise SystemExit("volume bootstrap CI has a non-positive entry")
    print(f"one-call volume extrap + CI ({rv:.0e} samples, {nrep} reps): {dt * 1e3:.1f} ms")

    # --- perturbation reweighting: the zero-derivative serving path
    # (reference PerturbModel), logsumexp-stabilized reweight + Poisson CI,
    # checked against the analytic ideal gas
    pbetas = torch.tensor([1.9, 2.0, 2.1], dtype=torch.float64, device=dev)
    run_pert = make_perturb_pipeline(beta0, nrep=nrep)
    run_pert(u, x, pbetas, seed=7)
    (ppred, pstd), dt = _timed(lambda: run_pert(u, x, pbetas, seed=8))
    pexact = np.array([float(idealgas.x_ave(float(b))) for b in pbetas])
    ppred, pstd = ppred.reshape(-1).cpu().numpy(), pstd.reshape(-1).cpu().numpy()
    print(f"one-call perturb reweight + CI ({u.shape[0]:.0e} records, {nrep} reps): {dt * 1e3:.1f} ms")
    for b, p, s, e in zip(pbetas.tolist(), ppred, pstd, pexact):
        print(f"  beta={b:.2f}: pred={p:.6f} +/- {s:.1e}  analytic={e:.6f}")
    # at beta0 reweighting is the plain sample mean
    if not abs(ppred[1] - pexact[1]) < 1e-3:
        raise SystemExit(f"perturbation at beta0 off the analytic <x> by {abs(ppred[1] - pexact[1]):.2e}")
    if not np.all(pstd > 0):
        raise SystemExit("perturbation CI has a non-positive entry")
    return {"beta0_abs_err": float(err[2]), "bf16_max_diff": bf16_diff, "perturb_beta0_abs_err": float(abs(ppred[1] - pexact[1]))}


if __name__ == "__main__":
    run(main, "serving_pipeline")

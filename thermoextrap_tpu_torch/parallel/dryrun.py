"""One sharded training step on a world of gloo ranks on the CPU, checked
against one device: the counterpart of ``__graft_entry__.dryrun_multichip``.

:func:`dryrun_multichip` spawns ``n_devices`` processes, joins them into a
gloo world on a ``file://`` store, lays a 2-D ``(rep, rec)`` mesh over them
(:func:`.sharded.make_mesh`) and runs, on every rank:

- the train step: the sharded reduction and bootstrap, the coefficients of
  ``central_x_ave_coefs``, the variance-weighted surrogate of the predictions
  and one ``torch.autograd`` step on it;
- equality with one device: the reduction (rtol 1e-11, atol 1e-13) and the
  bootstrap (rtol 1e-9, atol 1e-12) against the plain functions, the
  ``mesh=`` pipeline against the unsharded one at the same seed (prediction
  rtol 1e-10, standard deviation rtol 1e-8), the xalpha, volume and
  perturbation pipelines likewise.

Any failure in any rank fails the call, which raises with each failed rank's
traceback; a rank that does not finish within ``timeout`` seconds is killed.

    python -m thermoextrap_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import tempfile
import traceback

__all__ = ["dryrun_multichip"]

ORDER = 6
N_ALPHAS = 5
BETA0 = 1.0


def _close(name, got, want, rtol, atol=0.0):
    import numpy as np

    np.testing.assert_allclose(
        np.asarray(got.detach().cpu()), np.asarray(want.detach().cpu()), rtol=rtol, atol=atol, err_msg=name
    )


def _step(n_devices: int) -> None:
    import torch

    from .. import set_default_device
    from ..models.derivatives import central_x_ave_coefs
    from ..ops import moments, resample
    from ..pipeline import make_extrap_pipeline, make_perturb_pipeline, make_volume_pipeline
    from .sharded import _full, make_mesh, reduce_central_comoments_sharded, resample_central_comoments_sharded, shard_rec

    set_default_device("cpu")
    mesh = make_mesh(n_devices, axis_names=("rep", "rec"), device="cpu")
    n_rep, n_rec = mesh.shape
    r, v, nrep = 64 * n_rec, 2, 8 * n_rep

    # the same data on every rank, from one seed
    gen = torch.Generator().manual_seed(0)
    uv = 5.0 + torch.randn(r, generator=gen, dtype=torch.float64)
    xv = 2.0 + 0.5 * torch.randn(r, v, generator=gen, dtype=torch.float64)
    freq = resample.freq_from_indices(resample.random_indices(gen, nrep, r), r)
    betas = torch.linspace(0.8, 1.2, N_ALPHAS, dtype=torch.float64)
    us, xs = shard_rec(uv, mesh), shard_rec(xv, mesh)

    # the train step: sharded reduction and bootstrap, coefficients, the
    # variance-weighted surrogate and one gradient step
    params = torch.zeros(N_ALPHAS, dtype=torch.float64, requires_grad=True)
    xave, _u, du, dxdu = reduce_central_comoments_sharded(us, xs, ORDER, mesh)
    coefs = central_x_ave_coefs(xave, du[:, None], dxdu, ORDER)
    bx, _bu, bdu, bdxdu = _full(*resample_central_comoments_sharded(us, xs, freq, ORDER, mesh))
    bcoefs = central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, ORDER)
    powers = torch.stack([(betas - BETA0) ** k for k in range(ORDER + 1)], dim=-1)
    pred = powers @ coefs.reshape(ORDER + 1, -1)  # (A, V)
    bpred = torch.einsum("ak,k...->a...", powers, bcoefs)  # (A, nrep, V)
    var = bpred.var(dim=1, correction=0).mean(-1)
    loss = torch.sum((pred.mean(-1) + params) ** 2 / (var + 1e-6))
    loss.backward()
    new_params = params.detach() - 1e-3 * params.grad
    if tuple(new_params.shape) != (N_ALPHAS,) or not bool(torch.isfinite(pred).all() and torch.isfinite(new_params).all()):
        msg = f"train step: non-finite or misshapen results (pred {pred.tolist()}, params {new_params.tolist()})"
        raise AssertionError(msg)

    # equality with one device
    for a, b in zip(reduce_central_comoments_sharded(us, xs, ORDER, mesh), moments.reduce_central_comoments(uv, xv, ORDER)):
        _close("sharded reduce != single-device reduce", a, b, 1e-11, 1e-13)
    for a, b in zip((bx, _bu, bdu, bdxdu), resample.resample_central_comoments(uv, xv, freq, ORDER)):
        _close("sharded bootstrap != single-device bootstrap", a, b, 1e-9, 1e-12)

    p_pred, p_std = make_extrap_pipeline(ORDER, BETA0, nrep=nrep, mesh=mesh)(us, xs, betas, seed=0)
    u_pred, u_std = make_extrap_pipeline(ORDER, BETA0, nrep=nrep)(uv, xv, betas, seed=0)
    _close("mesh pipeline pred != single-device pipeline pred", p_pred, u_pred, 1e-10)
    _close("mesh pipeline CI != single-device pipeline CI", p_std, u_std, 1e-8)
    if not bool((p_std > 0).all()):
        raise AssertionError(f"non-positive pipeline CI: {p_std.tolist()}")

    # the beta-dependent observable: its derivative columns ride as values
    xvx = torch.cat([(BETA0 * xv)[:, None], xv[:, None], torch.zeros(r, ORDER - 1, v, dtype=xv.dtype)], dim=1)
    xp_m, xs_m = make_extrap_pipeline(ORDER, BETA0, xalpha=True, nrep=nrep, mesh=mesh)(us, shard_rec(xvx, mesh), betas, seed=0)
    xp_u, xs_u = make_extrap_pipeline(ORDER, BETA0, xalpha=True, nrep=nrep)(uv, xvx, betas, seed=0)
    _close("mesh xalpha pipeline != single-device xalpha pipeline", xp_m, xp_u, 1e-10)
    _close("mesh xalpha CI != single-device xalpha CI", xs_m, xs_u, 1e-8, 1e-12)

    # the volume pipeline: one packed order-1 reduction
    dxdqv = 0.1 * xv + 0.05 * torch.randn(r, v, generator=gen, dtype=torch.float64)
    vols = torch.linspace(1.8, 2.2, N_ALPHAS, dtype=torch.float64)
    vp_m, vs_m = make_volume_pipeline(2.0, ndim=3, nrep=nrep, mesh=mesh)(us, xs, shard_rec(dxdqv, mesh), vols, seed=0)
    vp_u, vs_u = make_volume_pipeline(2.0, ndim=3, nrep=nrep)(uv, xv, dxdqv, vols, seed=0)
    _close("mesh volume pipeline != single-device volume pipeline", vp_m, vp_u, 1e-10)
    _close("mesh volume CI != single-device volume CI", vs_m, vs_u, 1e-8, 1e-12)

    # perturbation reweighting: the maximum and the sums all-reduced
    pp_m, ps_m = make_perturb_pipeline(BETA0, nrep=nrep, mesh=mesh)(uv, xv, betas, seed=2)
    pp_u, ps_u = make_perturb_pipeline(BETA0, nrep=nrep)(uv, xv, betas, seed=2)
    _close("mesh perturb pipeline != single-device perturb pipeline", pp_m, pp_u, 1e-10)
    _close("mesh perturb CI != single-device perturb CI", ps_m, ps_u, 1e-8, 1e-12)


def _rank(rank: int, n_devices: int, store: str, timeout: float, queue) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=n_devices, timeout=datetime.timedelta(seconds=timeout)
        )
        _step(n_devices)
        queue.put((rank, None))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """Run :mod:`this module <.dryrun>`'s sharded step on ``n_devices``
    spawned gloo ranks on the CPU and check it against one device; raises
    ``RuntimeError`` with the traceback of every rank that failed or did not
    finish within ``timeout`` seconds."""
    import queue as queue_mod

    n_devices = int(n_devices)
    if n_devices < 1:
        msg = f"n_devices must be >= 1, got {n_devices}"
        raise ValueError(msg)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="thermoextrap_dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, n_devices, store, timeout, results)) for r in range(n_devices)]
        for p in procs:
            p.start()
        failures = {}
        done = set()
        try:
            for _ in range(n_devices):
                rank, err = results.get(timeout=timeout)
                done.add(rank)
                if err is not None:
                    failures[rank] = err
        except queue_mod.Empty:
            for r in set(range(n_devices)) - done:
                failures[r] = f"no result within {timeout} s"
        finally:
            for p in procs:
                p.join(timeout=10 if not failures else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        text = "\n".join(f"rank {r}:\n{failures[r]}" for r in sorted(failures))
        msg = f"dryrun_multichip({n_devices}) failed on {len(failures)} of {n_devices} ranks:\n{text}"
        raise RuntimeError(msg)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    print("dryrun_multichip: ok")

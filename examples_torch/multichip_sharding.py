"""Sharded moment reduction + bootstrap over a device mesh, on the port.

The PyTorch form of ``examples/multichip_sharding.py``: the sample axis
(rec) is sharded over the mesh for the reduction, and a 2D (rep, rec) mesh
shards the bootstrap's count table.  Where the reference lays its mesh over
virtual XLA devices, this script spawns a world of ranks, one device each,
joined by ``torch.distributed`` on a ``file://`` store:

- ``--smoke``: 8 gloo ranks on the CPU, as the reference's 8 virtual devices;
- full size: one NCCL rank per CUDA card (``torch.cuda.device_count()``).

Every rank makes the same samples from one seed; the mesh functions reduce
their rank's block and merge the partial sums with all-reduces, launching no
kernel.  The 2D section runs on a world of any size (the reference's needs
two devices), and every sharded result is held against the unsharded plain
function in float64 on the same data.

Run: python examples_torch/multichip_sharding.py          (CUDA cards, NCCL)
     python examples_torch/multichip_sharding.py --smoke  (CPU, 8 gloo ranks)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import traceback

SMOKE_RANKS = 8
TIMEOUT_S = 300.0
RTOL = 1e-9  # float64 sharded sums against the unsharded two-pass


def _shard_demo(world: int, smoke: bool) -> dict:
    """The reference script's body on this rank; returns rank-0 numbers."""
    import torch

    from thermoextrap_tpu_torch import default_device
    from thermoextrap_tpu_torch.ops import moments, resample
    from thermoextrap_tpu_torch.ops.resample import freq_from_indices, random_indices
    from thermoextrap_tpu_torch.parallel import (
        make_mesh,
        reduce_central_comoments_sharded,
        reduce_central_umoments_batched_sharded,
        resample_central_comoments_sharded,
        resample_central_umoments_batched_sharded,
        shard_rec,
    )
    from thermoextrap_tpu_torch.utils.device import is_dtensor

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t

    def worst(got, want):
        err = 0.0
        for g, w in zip(got, want):
            g, w = full(g).double(), w.double()
            err = max(err, float(((g - w).abs() / (w.abs() + 1e-12)).max()))
        return err

    dev = default_device()
    order, r, v, nrep = 6, (1 << 12 if smoke else 1 << 16), 2, 32
    gen = torch.Generator(device=dev).manual_seed(0)  # the same samples on every rank
    uv = 5.0 + torch.randn(r, generator=gen, device=dev, dtype=torch.float64)
    xv = 2.0 + 0.5 * torch.randn((r, v), generator=gen, device=dev, dtype=torch.float64)

    mesh = make_mesh(world, axis_names=("rec",))
    out = reduce_central_comoments_sharded(shard_rec(uv, mesh), shard_rec(xv, mesh), order, mesh)
    res = {"reduce_du_2_4": full(out[2])[2:4].reshape(-1).tolist()}
    res["reduce_rel_err"] = worst(out, moments.reduce_central_comoments(uv, xv, order))

    mesh2 = make_mesh(world, axis_names=("rep", "rec"))
    freq = freq_from_indices(random_indices(gen, nrep, r), r)
    boot = resample_central_comoments_sharded(uv, xv, freq, order, mesh2)
    xave, _u, du, _dx = (full(t) for t in boot)
    res["boot_du2_mean"] = float(du[2].mean())
    res["boot_xave_std"] = xave.std(dim=0).reshape(-1).tolist()
    res["boot_rel_err"] = worst(boot, resample.resample_central_comoments(uv, xv, freq, order))

    # lnPi-style macrostate grid: batched u-moment reduce + shared-count
    # grid bootstrap, both sharded on the sample axis (the functions place
    # the whole grid with its last axis on ``rec``)
    n_grid = 6
    uvg = torch.linspace(-1, 1, n_grid, device=dev, dtype=torch.float64)[:, None] + torch.randn(
        (n_grid, r), generator=gen, device=dev, dtype=torch.float64
    )
    grid = reduce_central_umoments_batched_sharded(uvg, order, mesh2)
    res["grid_uave"] = full(grid[0])[:3].tolist()
    res["grid_rel_err"] = worst(grid, moments.reduce_central_umoments(uvg, order))
    gboot = resample_central_umoments_batched_sharded(uvg, freq, order, mesh2)
    res["grid_boot_sem"] = full(gboot[0]).std(dim=0)[:3].tolist()
    res["grid_boot_rel_err"] = worst(gboot, resample.resample_central_umoments_batched(uvg, freq, order))
    res["mesh_shape"] = list(mesh2.shape)
    return res


def _rank(rank: int, world: int, store: str, smoke: bool, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        import thermoextrap_tpu_torch as xt
        from thermoextrap_tpu_torch.ops.moments_cuda import LAUNCHES

        if smoke:
            xt.set_default_device("cpu")
        else:
            torch.cuda.set_device(rank)
            xt.set_default_device(torch.device("cuda", rank))
        dist.init_process_group(
            "gloo" if smoke else "nccl",
            init_method=f"file://{store}",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
        out = _shard_demo(world, smoke)
        results.put((rank, out, dict(LAUNCHES), None))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, None, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(smoke: bool = SMOKE) -> dict:
    import torch

    world = SMOKE_RANKS if smoke else torch.cuda.device_count()
    print(f"world: {world} {'gloo ranks on the CPU' if smoke else 'NCCL ranks, one CUDA card each'}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    outs, launches, failures = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="multichip_sharding_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, world, store, smoke, results)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            for _ in range(world):
                rank, out, counts, err = results.get(timeout=TIMEOUT_S)
                if err is not None:
                    failures[rank] = err
                else:
                    outs[rank], launches[rank] = out, counts
        except queue_mod.Empty:
            for r in set(range(world)) - set(outs) - set(failures):
                failures[r] = f"no result within {TIMEOUT_S} s"
        finally:
            for p in procs:
                p.join(timeout=10 if not failures else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        text = "\n".join(f"rank {r}:\n{failures[r]}" for r in sorted(failures))
        raise SystemExit(f"{len(failures)} of {world} ranks failed:\n{text}")

    res = outs[0]
    print(f"mesh (rep, rec): {tuple(res['mesh_shape'])}")
    print("sharded reduce du[2:4]:", res["reduce_du_2_4"])
    print("bootstrap du[2] mean over reps:", res["boot_du2_mean"])
    print("bootstrap xave std over reps:", res["boot_xave_std"])
    print("grid reduce uave:", res["grid_uave"])
    print("grid bootstrap SEM:", res["grid_boot_sem"])
    rel = max(o[k] for o in outs.values() for k in ("reduce_rel_err", "boot_rel_err", "grid_rel_err", "grid_boot_rel_err"))
    print(f"max relative difference from the unsharded functions over every rank: {rel:.1e}")
    if not rel <= RTOL:
        raise SystemExit(f"sharded results differ from the unsharded ones by {rel:.2e} (bar {RTOL})")
    worker_launches = {k: sum(c[k] for c in launches.values()) for k in launches[0]}
    return {"max_rel_err_vs_unsharded": rel, "world": world, "worker_launches": worker_launches}


if __name__ == "__main__":
    run(main, "multichip_sharding")

"""A world of gloo ranks on the CPU for the torch port's sharded tests.

:func:`run_world` spawns ``world`` processes, joins them into one gloo group
on a ``file://`` store, lays a 1-D ``("rec",)`` and a 2-D ``("rep", "rec")``
mesh over them, runs every case on every rank and returns each rank's
results as numpy arrays.  A case is the name of a function of this module
and its arguments (numpy arrays and numbers): ``fn(meshes, *args)``.

This module imports neither jax nor ``tests/conftest.py``: each child
imports it to find its target.  Every multi-rank case runs in the children,
so no process group is ever left in the test process; a rank that does not
answer within the timeout fails the call.
"""

import multiprocessing
import os
import queue as queue_mod
import tempfile
import traceback

import numpy as np


def _numpy(out):
    """Results (tensors, DTensors, tuples, dicts, numbers) as numpy arrays."""
    import torch

    from thermoextrap_tpu_torch.utils.device import is_dtensor

    if isinstance(out, dict):
        return {k: _numpy(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return tuple(_numpy(v) for v in out)
    if is_dtensor(out):
        return out.full_tensor().detach().cpu().numpy()
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _rank_main(rank, world, store, cases, results):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        import thermoextrap_tpu_torch as tx
        from thermoextrap_tpu_torch.parallel import make_mesh

        tx.set_default_device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
        meshes = {"1d": make_mesh(world, ("rec",), device="cpu"), "2d": make_mesh(world, ("rep", "rec"), device="cpu")}
        out = {name: _numpy(globals()[fn](meshes, *args)) for name, (fn, args) in cases.items()}
        results.put((rank, out, None))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(cases: dict, world: int = 4, timeout: float = 240.0) -> list:
    """Every case on a spawned world of ``world`` gloo ranks; returns one
    dict of results per rank.  Raises with the traceback of a failed rank,
    or when a rank gives no result within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"  # the children's environment (tests/conftest.py NOTE)
    out = [None] * world
    errors = []
    with tempfile.TemporaryDirectory(prefix="torch_world_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world, os.path.join(tmp, "store"), cases, results)) for r in range(world)]
        try:
            for p in procs:
                p.start()
        finally:
            if saved is None:
                del os.environ["JAX_PLATFORMS"]
            else:
                os.environ["JAX_PLATFORMS"] = saved
        try:
            for _ in range(world):
                rank, res, err = results.get(timeout=timeout)
                out[rank] = res
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
        except queue_mod.Empty:
            errors.append(f"ranks {[r for r in range(world) if out[r] is None]} gave no result within {timeout} s")
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


# -- cases: each runs on every rank ---------------------------------------------------------


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a))


def reduce_comoments(meshes, mesh, u, x, w, order):
    from thermoextrap_tpu_torch.parallel import reduce_central_comoments_sharded, shard_rec

    m = meshes[mesh]
    return reduce_central_comoments_sharded(shard_rec(_t(u), m), shard_rec(_t(x), m), order, m, weight=w)


def resample_comoments(meshes, mesh, u, x, freq, order, w=None):
    from thermoextrap_tpu_torch.parallel import resample_central_comoments_sharded

    out = resample_central_comoments_sharded(u, x, freq, order, meshes[mesh], weight=w)
    return out, _placed_on_rep(out, meshes[mesh])


def _placed_on_rep(out, mesh):
    """Per output: whether it is a DTensor sharded on ``rep`` (True), or a
    plain tensor (False)."""
    from thermoextrap_tpu_torch.utils.device import is_dtensor

    return [bool(is_dtensor(o) and any(p.is_shard() for p in o.placements)) for o in out]


def reduce_umoments(meshes, mesh, u, order, w=None):
    from thermoextrap_tpu_torch.parallel import reduce_central_umoments_batched_sharded

    return reduce_central_umoments_batched_sharded(u, order, meshes[mesh], weight=w)


def resample_umoments(meshes, mesh, u, freq, order):
    from thermoextrap_tpu_torch.parallel import resample_central_umoments_batched_sharded

    out = resample_central_umoments_batched_sharded(u, freq, order, meshes[mesh])
    return out, _placed_on_rep(out, meshes[mesh])


def mbar_solve(meshes, u_kn, n_k, tol=None):
    from thermoextrap_tpu_torch.parallel import mbar_solve_sharded

    f, it, res = mbar_solve_sharded(u_kn, n_k, meshes["1d"], tol=tol)
    return f, it, res


def mbar_grid(meshes, u_kn, n_k, f_k, u_targets, x_n):
    from thermoextrap_tpu_torch.parallel import mbar_expectations_grid_sharded

    return mbar_expectations_grid_sharded(u_kn, n_k, f_k, u_targets, x_n, meshes["1d"])


def mbar_solve_and_grid(meshes, u_kn, n_k, u_targets, x_n):
    from thermoextrap_tpu_torch.parallel import mbar_expectations_grid_sharded, mbar_solve_sharded

    f, _, _ = mbar_solve_sharded(u_kn, n_k, meshes["1d"])
    return f, mbar_expectations_grid_sharded(u_kn, n_k, f, u_targets, x_n, meshes["1d"])


def pipeline(meshes, mesh, factory, kwargs, args, seed, shard=(), shard_last=()):
    """``make_<factory>_pipeline(**kwargs, mesh=...)(*args, seed=seed)``, the
    arguments listed in ``shard`` placed by ``shard_rec`` and those in
    ``shard_last`` sharded on their last axis; the rest whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from thermoextrap_tpu_torch import pipeline as tpipe
    from thermoextrap_tpu_torch.parallel import shard_rec

    m = meshes[mesh]
    run = getattr(tpipe, f"make_{factory}_pipeline")(**kwargs, mesh=m)
    placed = list(args)
    for i in shard:
        placed[i] = shard_rec(_t(args[i]), m)
    for i in shard_last:
        t = _t(args[i])
        placed[i] = distribute_tensor(t, m, [Shard(t.ndim - 1) if n == "rec" else Replicate() for n in m.mesh_dim_names])
    return run(*placed, seed=seed)


def streaming(meshes, mesh, factory, kwargs, chunks, predict_args, shard=True):
    """A streaming pipeline with ``mesh=``: ``update(state, *chunk)`` for each
    chunk (its arrays sharded by ``shard_rec``, or whole), then
    ``predict(state, *predict_args)``."""
    from thermoextrap_tpu_torch import pipeline as tpipe
    from thermoextrap_tpu_torch.parallel import shard_rec

    m = meshes[mesh]
    state, update, predict = getattr(tpipe, f"make_streaming_{factory}_pipeline")(**kwargs, mesh=m)
    for chunk in chunks:
        if factory == "interp":
            i, *arrs = chunk
            state = update(state, i, *(shard_rec(_t(a), m) if shard else a for a in arrs))
        elif factory == "lnpi":
            state = update(state, *chunk)
        else:
            state = update(state, *(shard_rec(_t(a), m) if shard else a for a in chunk))
    return predict(state, *predict_args)


def frozen_queries(meshes, x, y, cov, locs):
    """A float64 frozen predictor (the model untrained: the freeze needs
    parameters, not an optimum) on whole and on rec-sharded queries."""
    import torch

    from thermoextrap_tpu_torch.gpr_active.gp_models import HeteroscedasticGPR
    from thermoextrap_tpu_torch.gpr_active.kernels import RBFDerivKernel
    from thermoextrap_tpu_torch.gpr_active.serving import freeze_predictor
    from thermoextrap_tpu_torch.parallel import shard_rec

    model = HeteroscedasticGPR((x, y, cov), kernel=RBFDerivKernel(), likelihood_kwargs={"p": 1.0})
    pred = freeze_predictor(model, dtype=torch.float64)
    want = pred(locs)
    got = pred(shard_rec(_t(locs), meshes["1d"]))
    return want, got, [tuple(g.placements) == tuple(shard_rec(_t(locs), meshes["1d"]).placements) for g in got]


def checkpoint_roundtrip(meshes, path):
    """Save a rec-sharded leaf, restore it on a DTensor template."""
    import torch

    from thermoextrap_tpu_torch.parallel import shard_rec
    from thermoextrap_tpu_torch.utils import checkpoint as ck

    m = meshes["1d"]
    a = shard_rec(torch.arange(64.0), m)
    ck.save_pytree(path, {"a": a, "n": 3})
    out = ck.restore_pytree(path, {"a": shard_rec(torch.zeros(64), m), "n": 0})
    return out["a"], out["n"], out["a"].device_mesh == m and tuple(out["a"].placements) == tuple(a.placements)


def mesh_checks(meshes):
    """The meshes' shapes, and that a DTensor on another mesh, or placed
    otherwise, is refused."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from thermoextrap_tpu_torch.parallel import reduce_central_comoments_sharded, shard_rec

    m1, m2 = meshes["1d"], meshes["2d"]
    t = torch.linspace(0.0, 1.0, 32, dtype=torch.float64)
    refused = []
    for u, m in ((shard_rec(t, m1), m2), (distribute_tensor(t, m1, [Replicate()]), m1)):
        try:
            reduce_central_comoments_sharded(u, u, 2, m)
            refused.append(False)
        except ValueError:
            refused.append(True)
    return tuple(m1.shape), tuple(m2.shape), m2.mesh_dim_names, refused

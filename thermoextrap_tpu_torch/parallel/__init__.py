"""Multi-device sharding on ``torch.distributed``: the device mesh, sharded
moment reductions and bootstraps, and sharded MBAR (:mod:`.sharded`), with
the multi-rank self-check :func:`.dryrun.dryrun_multichip`."""

from .sharded import (
    make_mesh,
    mbar_expectations_grid_sharded,
    mbar_solve_sharded,
    reduce_central_comoments_sharded,
    reduce_central_umoments_batched_sharded,
    resample_central_comoments_sharded,
    resample_central_umoments_batched_sharded,
    shard_rec,
)

__all__ = [
    "make_mesh",
    "mbar_expectations_grid_sharded",
    "mbar_solve_sharded",
    "reduce_central_comoments_sharded",
    "reduce_central_umoments_batched_sharded",
    "resample_central_comoments_sharded",
    "resample_central_umoments_batched_sharded",
    "shard_rec",
]

"""The Poisson bootstrap of the central u-moments of every row of ``uv (B,
n)`` (``ops.moments_cuda.resample_central_umoments_batched_poisson``), one
count per replicate and sample shared by all rows: read the grid once,
write each replicate's moments; draw ``nrep * n`` counts; contract them with
``B (order+1)`` shifted power rows."""


def work(*, b: int, n: int, order: int, nrep: int, itemsize: int = 4) -> dict:
    return {
        "bytes": itemsize * b * n + 4 * nrep * b * (order + 2),
        "products": b * (order + 1) * nrep * n,
        "draws": nrep * n,
    }

"""Central u-moments of every row of ``uv (B, n)`` to ``order``
(``ops.dispatch.reduce_central_u``): read the grid once, write ``<u> (B)``
and ``du (order+1, B)``; one power per sample and order."""


def work(*, b: int, n: int, order: int, itemsize: int = 4) -> dict:
    return {"bytes": itemsize * b * n + 4 * b * (order + 2), "fmas": b * n * (order + 1)}

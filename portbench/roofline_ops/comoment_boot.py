"""The Poisson bootstrap of central comoments of ``u (R,)`` and ``x (R,
V)`` (``ops.moments_cuda.resample_central_comoments_poisson``): read both
once, write each replicate's comoments; draw ``nrep * R`` counts; contract
the counts with ``(V+1)(order+1)`` shifted power rows."""


def work(*, r: int, v: int, order: int, nrep: int, itemsize: int = 4) -> dict:
    rows = (v + 1) * (order + 1)
    out = nrep * (v + 1 + (order + 1) * (v + 1))
    return {"bytes": itemsize * r * (1 + v) + 4 * out, "products": nrep * r * rows, "draws": nrep * r}

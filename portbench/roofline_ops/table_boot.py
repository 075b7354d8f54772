"""One state's count-table bootstrap of central comoments of ``u (R,)`` and
``x (R, V)`` (``DataCentralMomentsVals.resample({"nrep": nrep})``: an index
table drawn, counted and contracted, whatever implements it): read both
once and write each replicate's comoments; draw ``nrep * R`` counts;
contract them with ``(V+1)(order+1)`` shifted power rows."""


def work(*, r: int, v: int, order: int, nrep: int, itemsize: int = 4) -> dict:
    rows = (v + 1) * (order + 1)
    out = nrep * (v + 1 + (order + 1) * (v + 1))
    return {"bytes": itemsize * r * (1 + v) + 4 * out, "products": nrep * r * rows, "draws": nrep * r}

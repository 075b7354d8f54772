"""Central comoments of ``u (R,)`` and ``x (R, V)`` to ``order``
(``ops.dispatch.reduce_central``): read both once, write ``<x> (V)``,
``<u>``, ``du (order+1)`` and ``dxdu (order+1, V)``; a power of ``u`` and a
product with each column per sample and order."""


def work(*, r: int, v: int, order: int, itemsize: int = 4) -> dict:
    out = v + 1 + (order + 1) * (v + 1)
    return {"bytes": itemsize * r * (1 + v) + 4 * out, "fmas": r * (order + 1) * (v + 1)}

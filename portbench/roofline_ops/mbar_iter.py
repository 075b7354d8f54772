"""One iteration of the MBAR solve over ``u_kn (K, N)``
(``models.mbar.mbar_solve_info``, the Newton / self-consistent hybrid): its
least work is to read ``u_kn`` once and take one exponential of each of its
elements (each state's weight of each sample)."""


def work(*, k: int, n: int, itemsize: int = 4) -> dict:
    return {"bytes": itemsize * k * n, "exps": k * n}

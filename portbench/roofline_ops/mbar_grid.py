"""MBAR's expectations at ``a`` linear-in-alpha targets
(``models.mbar.mbar_expectations_alphas``): read ``u_kn (K, N)``, the pooled
``u (N,)`` and ``x (N, V)`` once and write the ``(A, V)`` result; take the
mixture's log denominator (``K`` exponentials a sample) and each target's
weight of each sample (``A`` more); sum each target's weights and their
products with the ``V`` columns, ``A (V + 1)`` multiply-adds a sample on
the CUDA cores."""


def work(*, k: int, n: int, a: int, v: int, itemsize: int = 4) -> dict:
    return {
        "bytes": itemsize * n * (k + 1 + v) + 4 * a * v,
        "exps": (a + k) * n,
        "fmas": a * n * (v + 1),
    }

"""Extending the framework with a custom observable, on the port.

The PyTorch form of ``examples/custom_observable.py``.  The reference's
extension seam is subclassing ``SymFuncBase`` with sympy ``fdiff`` rules;
here there are two seams, both shown below:

1. ``Derivatives(coefs_fn=...)`` - write the observable's Taylor series in
   torch directly;
2. ``Derivatives.from_sympy(exprs, args)`` - bring sympy expressions (e.g.
   migrated from reference code); they are turned into torch once at build
   time.

The demo observable: the second moment <x^2>(beta) of the ideal gas,
treated as a plain observable through the standard x_ave machinery, against
the two custom engines.  The data are raw moments (``central=False``), which
reduce in float64 by the plain route on any device: no kernel runs.

Run: python examples_torch/custom_observable.py          (CUDA card, full size)
     python examples_torch/custom_observable.py --smoke  (CPU, small sizes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from _smoke import SMOKE, run

import math

import sympy as sp
import torch

import thermoextrap_tpu_torch as xt
from thermoextrap_tpu_torch import beta, idealgas
from thermoextrap_tpu_torch.models.derivatives import Derivatives
from thermoextrap_tpu_torch.ops.series import series_div


def custom_coefs_fn(args, order):
    """Seam 1: raw <x>(beta0+D) as a torch series ratio (what beta.x_ave does)."""
    u, xu = args
    a = torch.stack([(-1.0) ** n / math.factorial(n) * xu[n] for n in range(order + 1)])
    b = torch.stack([(-1.0) ** n / math.factorial(n) * u[n] for n in range(order + 1)])
    return series_div(a, b, order=order)


def sympy_exprs(order):
    """Seam 2: the same series division done symbolically (migration path)."""
    u_sym, xu_sym = sp.IndexedBase("u"), sp.IndexedBase("xu")
    fact = [sp.factorial(n) for n in range(order + 1)]
    a = [(-1) ** n * xu_sym[n] / fact[n] for n in range(order + 1)]
    b = [(-1) ** n * u_sym[n] / fact[n] for n in range(order + 1)]
    c = []
    for n in range(order + 1):
        c.append(sp.expand((a[n] - sum(b[k] * c[n - k] for k in range(1, n + 1))) / b[0]))
    return [sp.expand(c[n] * fact[n]) for n in range(order + 1)], (u_sym, xu_sym)


def main(smoke: bool = SMOKE) -> dict:
    order, beta0 = 3, 2.0
    pos = idealgas.x_sample((2_000, 50) if smoke else (20_000, 500), beta0, rng=0)
    xsq = (pos**2).mean(dim=-1)  # custom observable: <x^2> estimator
    u = pos.sum(dim=-1)

    data = xt.factory_data_values(uv=u, xv=xsq, order=order, central=False)

    m_native = beta.factory_extrapmodel(beta0, data)  # built-in engine
    m_custom = xt.ExtrapModel(beta0, data, Derivatives(coefs_fn=custom_coefs_fn, name="custom"), order=order)
    exprs, args = sympy_exprs(order)
    m_sympy = xt.ExtrapModel(beta0, data, Derivatives.from_sympy(exprs, args), order=order)

    b_eval = 2.3
    native = float(m_native.predict(b_eval))
    custom = float(m_custom.predict(b_eval))
    sympy_ = float(m_sympy.predict(b_eval))
    print("native :", native)
    print("custom :", custom)
    print("sympy  :", sympy_)
    diff = max(abs(custom - native), abs(sympy_ - native)) / abs(native)
    # the three engines compute one series in float64
    if not diff < 1e-10:
        msg = f"custom engines differ from the built-in one by {diff:.2e} relative"
        raise SystemExit(msg)
    return {"max_rel_diff_engines": diff, "native": native}


if __name__ == "__main__":
    run(main, "custom_observable")

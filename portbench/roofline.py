"""Published peaks of one NVIDIA H100 SXM and the least time a function's
work can take on it.

The peaks are NVIDIA's data-sheet figures at the card's full 700 W: HBM3 at
3.35 TB/s, 67 TFLOP/s in float32 on the CUDA cores, 989 TFLOP/s dense
bfloat16 on the tensor cores, and 16.75 T int32 operations a second (64
integer results per clock and SM, half the float32 rate).  Exponentials run
on the special-function units at 16 results per clock and SM (the CUDA C++
Programming Guide's arithmetic-throughput table, compute capability 9.0):
16 × 132 SMs × 1.98 GHz = 4.18 T a second.

A function's work is counted from its shapes alone by a file of its own,
``roofline_ops/<op>.py``, whose ``work(**shape)`` returns

- ``bytes``: each input byte read once and each output byte written once;
- ``fmas``: float32 multiply-adds that run on the CUDA cores;
- ``products``: products of a contraction, at the fastest unit a float32
  result allows: three bfloat16 terms a float32 operand on the tensor cores
  (``BF16_TERMS``);
- ``draws``: Poisson counts drawn in the kernel, each ``DRAW_OPS`` integer
  operations.  That figure is a convention: the port's Philox draw and its
  level lookup, amortised over the four counts of one Philox call;
- ``exps``: float32 exponentials, each one ``ex2`` at ``EXP2_RATE``.

The bound is the largest of these times; whatever kernel implements the
function, it counts the same work.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
INT32_OPS = 16.75e12
DRAW_OPS = 12
EXP2_RATE = 16 * 132 * 1.98e9
BF16_TERMS = 3

_OPS = Path(__file__).resolve().parent / "roofline_ops"


def op(name: str):
    """The module ``roofline_ops/<name>.py``."""
    path = _OPS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.roofline_ops.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(work: dict) -> tuple[float, str]:
    """``(ms, by)``: the least time of ``work`` and which term sets it."""
    terms = {
        "bytes": work.get("bytes", 0.0) / HBM_BPS,
        "fmas": 2.0 * work.get("fmas", 0.0) / F32_FLOPS,
        "products": 2.0 * BF16_TERMS * work.get("products", 0.0) / BF16_TC_FLOPS,
        "draws": DRAW_OPS * work.get("draws", 0.0) / INT32_OPS,
        "exps": work.get("exps", 0.0) / EXP2_RATE,
    }
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def bound_ms(name: str, **shape) -> float:
    return bound(op(name).work(**shape))[0]


def share_pct(name: str, device_ms: float, **shape) -> float:
    """The bound of ``name`` at ``shape`` as a percentage of ``device_ms``."""
    return 100.0 * bound_ms(name, **shape) / device_ms

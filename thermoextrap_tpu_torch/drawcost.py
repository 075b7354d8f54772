"""Integer instructions behind one in-kernel Poisson count, read from SASS.

Run from the repository root on a machine with the CUDA toolkit (no card is
needed)::

    python -m thermoextrap_tpu_torch.drawcost [SASS_FILE]

It compiles two probe kernels against ``csrc/philox.cuh`` with the package's
own ``nvcc`` flags.  Both fill the block's level table (``init``) and pass a
barrier; then ``draw_probe`` makes one ``PoissonCounts::load4`` call (a
Philox4x32-10 call and the word -> count map of 4 counts) and stores the four
counts, and ``base_probe`` stores the four counter words through a
conversion, without Philox and without the map.  Past the
barrier both are straight-line code, so the static instruction count is what
a thread executes.  ``cuobjdump -sass`` lists them, and the script prints one
JSON line with each kernel's instruction histogram and

- ``draw_instructions_per_count``: a quarter of (``draw_probe`` minus
  ``base_probe``) over the integer, logic, compare, select, bit-count and
  conversion opcodes, plus the one conversion per count that ``base_probe``
  holds (the draw turns words into counts by other means: the difference
  would otherwise take it away);
- ``wide_multiplies``, the ``IMAD.WIDE`` count of the draw (2 per Philox
  round when the compiler fuses the low and high halves of a product);
- ``shared_loads``, the draw's ``LDS`` count (one level lookup per count).

With a file name the SASS listing is written there.  ``chip_smoke.py`` puts
the per-count figure beside K3, K5 and K8 in its ``kernels`` line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["draw_cost", "main"]

_PROBE = r"""
#include "philox.cuh"

extern "C" __global__ void draw_probe(PoissonCounts pc, float4* out) {
  pc.init();
  __syncthreads();
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  float f[4];
  pc.load4((int)blockIdx.y, 4 * t, f);
  out[blockIdx.y * (long long)gridDim.x * blockDim.x + t] = make_float4(f[0], f[1], f[2], f[3]);
}

extern "C" __global__ void base_probe(PoissonCounts pc, float4* out) {
  pc.init();
  __syncthreads();
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long j = 4 * t;
  const uint32_t c[4] = {(uint32_t)(j >> 2), (uint32_t)blockIdx.y, (uint32_t)(j >> 34), pc.key.k0[0]};
  float f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] = (float)(int)c[q];
  out[blockIdx.y * (long long)gridDim.x * blockDim.x + t] = make_float4(f[0], f[1], f[2], f[3]);
}
"""

# opcodes of the integer pipes, bit counts, and the conversion that ends a count
_INTEGER = (
    "IMAD", "IADD3", "IADD", "LOP3", "LOP", "ISETP", "SEL", "SHF", "LEA", "I2F", "I2FP", "VIADD", "IABS",
    "PLOP3", "FLO", "POPC", "BREV", "PRMT", "IMNMX", "BMSK",
)
_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")


def _histograms(sass: str) -> dict:
    """``{function: {opcode: count}}`` of a ``cuobjdump -sass`` listing, the
    opcode without its modifiers except for ``IMAD.WIDE`` and ``IMAD.HI``."""
    out: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = out.setdefault(line.split("Function :")[1].strip(), {})
            continue
        found = _LINE.match(line)
        if current is None or not found:
            continue
        op, mods = found.group(1), found.group(2)
        if op == "IMAD" and (".WIDE" in mods or ".HI" in mods):
            op += ".WIDE" if ".WIDE" in mods else ".HI"
        current[op] = current.get(op, 0) + 1
    return out


def draw_cost() -> dict:
    from .ops import _build

    nvcc = Path(_build._nvcc())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "draw_probe.cu"
        obj = Path(tmp) / "draw_probe.o"
        src.write_text(_PROBE)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([str(nvcc), *flags, "-I", str(_build.CSRC_DIR), "-c", "-o", str(obj), str(src)], check=True)
        sass = subprocess.run(
            [str(nvcc.with_name("cuobjdump")), "-sass", str(obj)], capture_output=True, text=True, check=True
        ).stdout
    hist = _histograms(sass)
    draw, base = hist["draw_probe"], hist["base_probe"]

    def integer(h):
        return sum(n for op, n in h.items() if op.split(".")[0] in _INTEGER)

    return {
        "draw_probe": draw,
        "base_probe": base,
        "draw_integer_instructions": integer(draw),
        "base_integer_instructions": integer(base),
        "draw_instructions_per_count": (integer(draw) - integer(base)) / 4 + 1,
        "wide_multiplies": draw.get("IMAD.WIDE", 0),
        "shared_loads": draw.get("LDS", 0) - base.get("LDS", 0),
        "sass": sass,
    }


def main() -> int:
    cost = draw_cost()
    sass = cost.pop("sass")
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(sass)
    print(json.dumps(cost), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

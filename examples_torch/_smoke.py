"""``--smoke`` support and the closing record of the example CLIs on the port.

Each script of this directory is the PyTorch form of the script of the same
name in ``examples/``.  With ``--smoke`` it runs at the reference script's
smoke sizes on the CPU (``set_default_device("cpu")``), so the scripts double
as fast regression tests (``tests/test_torch_examples.py``).  Without the
flag it runs at full size on the CUDA card, and exits with status 2 when
there is none: it never carries on on the CPU.

Either way a script ends by printing one JSON line: its name, its wall time,
the kernel launch counts of ``thermoextrap_tpu_torch.ops.moments_cuda``
over the run (all 0 on the CPU) and the headline numbers its ``main()``
returned.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

SMOKE = "--smoke" in sys.argv
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run(main, name: str) -> None:
    """Run ``main()`` as the CLI ``name``: on the CPU with ``--smoke``, else on
    the card; then print the closing JSON line.  ``main`` returns a dict of
    JSON numbers; a ``"worker_launches"`` entry (launches counted in other
    processes) is added to this process's counts."""
    import torch

    import thermoextrap_tpu_torch as xt
    from thermoextrap_tpu_torch.ops.moments_cuda import LAUNCHES, reset_launches

    if SMOKE:
        xt.set_default_device("cpu")
    elif not torch.cuda.is_available():
        print(
            f"{name}: runs on a CUDA device unless --smoke is given, and torch.cuda.is_available() is False",
            file=sys.stderr,
        )
        raise SystemExit(2)
    reset_launches()
    t0 = time.perf_counter()
    result = dict(main() or {})
    if not SMOKE:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for k, v in result.pop("worker_launches", {}).items():
        launches[k] += v
    record = {"example": name, "smoke": SMOKE, "wall_s": wall, "launches": launches, "result": result}
    print(json.dumps(record), flush=True)

"""Run one cell of the port's benchmark on the CUDA card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``checks`` last, each
number compared with its limit, which also close standard error.  Without
a CUDA card (or with fewer cards than the cell asks for), or with JAX or
the JAX package loaded once the window has closed, it prints no result and
exits with 2 or 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    chips = next(w["chips"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start=T_START)
    foreign = sorted(set(out["foreign"]) | set(harness.foreign_modules(sys.modules)))
    if foreign:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(foreign)}", file=sys.stderr)
        return 3
    line = harness.result_line(cell, out, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings behind a cell's limits: the program's numbers over many seeds
and the control's, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 [--seconds 2] [--first-seed N]

Each seed makes the cell's inputs anew, runs a short window of the cell's
own calls and checks them as a run does (``pred_err``, ``sigma_err``).  The
control is the program on its bfloat16 stream, the nearest precision below
the configuration's float32 (``models/<model>.py``, ``control=True``).
One JSON line per seed, then a summary line: the largest reading of the
program (the lower reading of each limit) and the smallest of the control
(the upper).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)


def readings(cell, seeds, seconds: float, device, *, control: bool) -> list[dict]:
    from portbench import harness

    out = []
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run(cell, seed, seconds, False, device, t_start=t, control=control)
        row = {
            "variant": "control" if control else "program",
            "seed": seed,
            "calls": len(res["window"].latencies_s),
            "failed": res["window"].failed,
            **{k: v["value"] for k, v in res["checks"].items()},
            "seconds": time.perf_counter() - t,
        }
        print(json.dumps(row), flush=True)
        out.append(row)
        del res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds + args.control_seeds)]
    prog = readings(cell, seeds[: args.seeds], args.seconds, device, control=False)
    ctrl = readings(cell, seeds[args.seeds :], args.seconds, device, control=True)
    names = sorted({k for r in prog + ctrl for k in r} - {"variant", "seed", "calls", "failed", "seconds"})
    summary = {
        "workload": args.workload,
        "lower": {k: max(r[k] for r in prog if k in r) for k in names if any(k in r for r in prog)},
        "upper": {k: min(r[k] for r in ctrl if k in r) for k in names if any(k in r for r in ctrl)},
        "limits": cell.limits,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

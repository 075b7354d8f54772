"""Shared set-up of the harness's CPU tests: the repository on the path,
the port on the CPU, and each cell at a tiny size in float64 (the port's
CPU route reduces in the samples' dtype).

The cells are ``BENCHMARK.json``'s, in its order, and each configuration's
test sizes are in ``sizes/<config>.json``: ``tiny`` for these CPU runs,
``small`` for the card's control test.  A cell or a configuration is added
to the tests by its files alone."""

import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import thermoextrap_tpu_torch as xt  # noqa: E402
from portbench import harness  # noqa: E402

xt.set_default_device("cpu")

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])
SIZES = REPO / "portbench" / "tests" / "sizes"
SEED = 2**31 + 12_345


def sizes(config: str, kind: str) -> dict:
    """The ``kind`` (``"tiny"`` or ``"small"``) sizes of configuration ``config``."""
    return json.loads((SIZES / f"{config}.json").read_text())[kind]


def cell_sizes(name: str, kind: str) -> dict:
    """The ``kind`` sizes of the configuration that cell ``name`` runs."""
    return sizes(next(w["config"] for w in BENCH["workloads"] if w["name"] == name), kind)


def tiny_cell(name: str):
    nrep = harness.load_cell(name).traffic["nrep"]
    return harness.load_cell(name, {"config": cell_sizes(name, "tiny"), "traffic": {"nrep": min(nrep, 16)}})


def run_tiny(name: str, *, trace: bool = False, seconds: float = 0.4, seed: int = SEED):
    """One run of cell ``name`` at its tiny size on the CPU: ``(out, line)``."""
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    out = harness.run(cell, seed, seconds, trace, cpu, t_start=time.perf_counter())
    return out, harness.result_line(cell, out, trace, cpu)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)

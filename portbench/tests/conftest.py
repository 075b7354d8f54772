"""Shared set-up of the harness's CPU tests: the repository on the path,
the port on the CPU, and each cell at a tiny size in float64 (the port's
CPU route reduces in the samples' dtype)."""

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

CELLS = ("ig_beta6.boot256", "lnpi_lj1101.boot256", "ig_beta6.point", "ig_beta6.stream")
TINY = {
    "ig_beta6": {"samples": 40_000, "dtype": "float64"},
    "lnpi_lj1101": {"samples_per_macrostate": 2_000, "dtype": "float64"},
}
SEED = 2**31 + 12_345


def tiny_cell(name: str):
    nrep = harness.load_cell(name).traffic["nrep"]
    return harness.load_cell(name, {"config": TINY[name.split(".")[0]], "traffic": {"nrep": min(nrep, 16)}})


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

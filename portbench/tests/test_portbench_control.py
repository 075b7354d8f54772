"""The control comes out as not correct, and the program as correct, on the
card: the program on its bfloat16 stream (the nearest precision below the
configurations' float32) at a tenth of each cell's samples; three seeds
each.  ``calibrate.py`` reads the same at the cells' own sizes."""

import time

import pytest
from conftest import CELLS

from portbench import harness

pytestmark = pytest.mark.cuda
SMALL = {"ig_beta6": {"samples": 10_000_000}, "lnpi_lj1101": {"samples_per_macrostate": 10_000}}
SEEDS = (2**31 + 11, 2**31 + 7919, 2**31 + 104_729)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(cuda_device, name, seed):
    cell = harness.load_cell(name, {"config": SMALL[name.split(".")[0]]})
    program = harness.run(cell, seed, 1.0, False, cuda_device, t_start=time.perf_counter())
    control = harness.run(cell, seed, 1.0, False, cuda_device, t_start=time.perf_counter(), control=True)
    assert program["correct"] is True, program["checks"]
    assert control["correct"] is False, control["checks"]

"""The control comes out as not correct, and the program as correct, on the
card: the program on its bfloat16 stream (the nearest precision below the
configurations' float32) at each configuration's ``small`` sizes in
``sizes/<config>.json``; three seeds each.  ``calibrate.py`` reads the same at the cells' own sizes."""

import time

import pytest
from conftest import CELLS, cell_sizes

from portbench import harness

pytestmark = pytest.mark.cuda
SEEDS = (2**31 + 11, 2**31 + 7919, 2**31 + 104_729)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(cuda_device, name, seed):
    cell = harness.load_cell(name, {"config": cell_sizes(name, "small")})
    program = harness.run(cell, seed, 1.0, False, cuda_device, t_start=time.perf_counter())
    control = harness.run(cell, seed, 1.0, False, cuda_device, t_start=time.perf_counter(), control=True)
    assert program["correct"] is True, program["checks"]
    assert control["correct"] is False, control["checks"]

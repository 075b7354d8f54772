"""Seconds from the start of the process to the first timed call: imports,
the kernels' build or load, the inputs made on the device, and the warm-up
of the cell's own shapes."""


def read(window) -> float:
    return window.setup_s

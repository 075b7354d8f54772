"""Milliseconds a call: the whole measured window over the calls completed
in it (a call ends with its answer in host memory)."""


def read(window) -> float:
    return 1e3 * window.wall_s / len(window.latencies_s)

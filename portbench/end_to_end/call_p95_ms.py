"""The 95th percentile of the latency of every call in the window, in
milliseconds."""

import numpy as np


def read(window) -> float:
    return 1e3 * float(np.percentile(np.asarray(window.latencies_s), 95))

"""lookup_p99_ms: the 99th percentile (linear between ranks) of every
batch's latency in the window, host clock from the call to the answers
on the host, in ms."""

import numpy as np


def read(window) -> float:
    lat = np.array([t1 - t0 for t0, t1, _ in window.ops])
    return float(np.percentile(lat, 99)) * 1e3

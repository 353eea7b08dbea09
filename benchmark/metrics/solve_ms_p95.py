"""The 95th percentile of every solve's latency in the window, in ms: the
host clock from the call of `solve` until its first control is on the
host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3

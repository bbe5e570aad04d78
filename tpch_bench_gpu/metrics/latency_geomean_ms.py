"""latency_geomean_ms: the geometric mean of every completed request's
latency, the form of TPC-H's Power@Size; it keeps the short queries
weighted."""

import numpy as np


def read(run):
    done = run.completed
    return float(np.exp(np.mean(np.log([r.latency_s * 1e3 for r in done])))) if done else None

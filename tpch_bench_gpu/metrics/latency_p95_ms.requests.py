"""latency_p95_ms.requests: the 95th percentile (linear interpolation) of
every completed request's host-clock time from issue to its columns on the
host. A per-layer reading: with the card idle for most of the window, the
tail swings with the host's speed and with which texts overlap under one
interpreter lock (PERF.md section 2)."""

import numpy as np


def read(run):
    done = run.completed
    return float(np.percentile([r.latency_s * 1e3 for r in done], 95)) if done else None

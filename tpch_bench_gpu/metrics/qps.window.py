"""qps.window: requests completed over the window's seconds, from the
window's start to the last completion (requests in flight at --seconds
included): TPC-H's Throughput@Size in per-second form. A per-layer
reading: with two closed-loop clients under one interpreter lock it moves
with the host's speed by more than an end-to-end bound may hold
(PERF.md section 2)."""


def read(run):
    done = run.completed
    return len(done) / run.window_s if done else None

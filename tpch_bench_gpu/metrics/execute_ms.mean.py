"""execute_ms.mean: mean over the window's requests of the program's
StatementMetrics execute seconds, taken after the device has finished."""


def read(run):
    done = run.completed
    return sum(r.execute_s for r in done) / len(done) * 1e3 if done else None

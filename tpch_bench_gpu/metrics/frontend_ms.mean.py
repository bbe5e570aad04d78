"""frontend_ms.mean: mean over the window's requests of the program's
StatementMetrics parse + translate + optimize + compile seconds (the plan
cache's hit leaves parse and compile)."""


def read(run):
    done = run.completed
    return sum(r.frontend_s for r in done) / len(done) * 1e3 if done else None

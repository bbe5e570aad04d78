"""fetch_ms.mean: mean over the window's requests of the benchmark's span
around Table.to_pandas(), the result's columns read to the host."""


def read(run):
    done = run.completed
    return sum(r.fetch_s for r in done) / len(done) * 1e3 if done else None

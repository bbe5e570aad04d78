"""setup_retries: the capacity oracle's misses in set-up: the program's
`compiled_counts()["retries"]` (every overflow `grow` raised in the
process, each a new learning run and capture) less the window's requests'
summed retries. Nothing where the program has no `compiled_counts` or
captured no graph (CPU tensors)."""

from tpch_bench_gpu import program_counters


def read(run):
    counts = program_counters.compiled_counts()
    if counts is None:
        return None
    return counts["retries"] - sum(r.retries or 0 for r in run.completed)

"""graph_pool_gb: the most device memory the captured graphs' private
pools held at once, in GB (the program's
`compiled_counts()["pool_bytes_peak"]` / 1e9). Nothing where the program
has no `compiled_counts` or captured no graph (CPU tensors)."""

from tpch_bench_gpu import program_counters


def read(run):
    counts = program_counters.compiled_counts()
    return None if counts is None else counts["pool_bytes_peak"] / 1e9

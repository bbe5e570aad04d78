"""Benchmark harness (bench/runner.py) and operator microbenchmarks
(bench/micro.py)."""

from hyrise_tpu_torch.bench.runner import BenchmarkConfig, BenchmarkRunner  # noqa: F401

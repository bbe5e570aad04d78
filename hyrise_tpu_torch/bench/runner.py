"""Benchmark harness.

Port of hyrise_tpu/bench/runner.py (reference:
src/benchmarklib/benchmark_runner.{hpp,cpp}): modes IndividualQueries (each
query repeatedly) and PermutedQuerySets (the whole set in random order),
stop on max runs or duration, warm-up, a google-benchmark-style JSON report
with per-query durations and a context block (the devices, the scale
factor). Also TableGenerator (src/benchmarklib/table_generator.*) for
synthetic uniform tables.

A query's time is host-clock from the call to its result on the device: a
result table on a CUDA device is waited for with torch.cuda.synchronize.
"""

from __future__ import annotations

import dataclasses
import json
import platform
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class BenchmarkConfig:
    """Reference: BenchmarkConfig (benchmark_utils.hpp:99-140)."""

    mode: str = "individual"          # individual | permuted
    max_runs: int = 10
    max_duration_s: float = 30.0
    warmup_runs: int = 1
    verbose: bool = False
    scale_factor: float = 1.0
    # write the (partial) report after EVERY query so a killed long run
    # still leaves its completed measurements on disk
    report_path: str = ""
    # further entries of the report's context (the execution form, ...)
    context: Dict[str, object] = dataclasses.field(default_factory=dict)


def devices() -> List[str]:
    """Every CUDA device's name and power limit as nvidia-smi reports them,
    or ["cpu"] where there is none."""
    if not torch.cuda.is_available():
        return ["cpu"]
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        lines = []
    return [lines[i] if i < len(lines) else torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())]


class BenchmarkRunner:
    def __init__(self, config: BenchmarkConfig,
                 queries: Dict[str, Callable[[], object]]):
        """queries: name -> zero-arg callable executing the query once and
        returning the result table (or anything)."""
        self.config = config
        self.queries = queries
        self.results: Dict[str, List[float]] = {name: [] for name in queries}

    def _run_one(self, name: str) -> float:
        t0 = time.perf_counter()
        out = self.queries[name]()
        # a table on the card: wait for the device work behind it
        device = getattr(out, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    def run(self) -> None:
        cfg = self.config
        if cfg.mode == "individual":
            for name in self.queries:
                try:
                    for _ in range(cfg.warmup_runs):
                        self._run_one(name)
                    t_start = time.time()
                    for _ in range(cfg.max_runs):
                        if time.time() - t_start > cfg.max_duration_s:
                            break
                        self.results[name].append(self._run_one(name))
                except Exception as e:  # one query must not kill the suite
                    self.results[name].clear()
                    print(f"{name}: FAILED {type(e).__name__}: {str(e)[:200]}")
                    continue
                if cfg.verbose:
                    m = np.median(self.results[name]) * 1e3
                    print(f"{name}: median {m:.2f}ms over "
                          f"{len(self.results[name])} runs")
                if cfg.report_path:
                    self.write_report(cfg.report_path)
        elif cfg.mode == "permuted":
            rng = np.random.default_rng(0)
            names = list(self.queries)
            for _ in range(cfg.warmup_runs):
                for name in names:
                    self._run_one(name)
            t_start = time.time()
            for _ in range(cfg.max_runs):
                if time.time() - t_start > cfg.max_duration_s:
                    break
                order = rng.permutation(len(names))
                for i in order:
                    self.results[names[i]].append(self._run_one(names[i]))
        else:
            raise ValueError(f"unknown mode {cfg.mode!r}")

    def report(self) -> dict:
        """google-benchmark-like JSON report (reference:
        benchmark_runner.cpp JSON output)."""
        benchmarks = []
        for name, times in self.results.items():
            if not times:
                continue
            benchmarks.append({
                "name": name,
                "iterations": len(times),
                "real_time_ms": float(np.median(times) * 1e3),
                "min_time_ms": float(np.min(times) * 1e3),
                "max_time_ms": float(np.max(times) * 1e3),
                "items_per_second": float(1.0 / np.median(times)),
            })
        return {
            "context": {
                "date": time.strftime("%Y-%m-%d %H:%M:%S"),
                "host": platform.node(),
                "devices": devices(),
                "mode": self.config.mode,
                "scale_factor": self.config.scale_factor,
                **self.config.context,
            },
            "benchmarks": benchmarks,
        }

    def write_report(self, path: str) -> None:
        """Merge by query name with any report already at `path`: fresh
        measurements win per query, queries only in the old file stay, so a
        partial re-run never shrinks the report."""
        report = self.report()
        try:
            with open(path) as f:
                old = json.load(f)
            merged = {b["name"]: b for b in old.get("benchmarks", [])}
        except (OSError, ValueError):
            merged = {}
        merged.update({b["name"]: b for b in report["benchmarks"]})
        report["benchmarks"] = [merged[k] for k in sorted(merged)]
        with open(path, "w") as f:
            json.dump(report, f, indent=2)


def generate_synthetic_table(num_rows: int, num_columns: int,
                             max_value: int = 10000, seed: int = 0, *, device="cuda"):
    """Reference: table_generator.cpp — a uniform random int32 table on
    `device`."""
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
    from hyrise_tpu_torch.types import DataType

    rng = np.random.default_rng(seed)
    defs = [TableColumnDefinition(f"column_{i}", DataType.INT32)
            for i in range(num_columns)]
    arrays = [rng.integers(0, max_value, num_rows).astype(np.int32)
              for _ in range(num_columns)]
    return Table.from_arrays("benchmark_table", defs, arrays, device=device)

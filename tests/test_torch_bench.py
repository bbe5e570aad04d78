"""The port's benchmark harness (hyrise_tpu_torch/bench/runner.py) and
operator microbenchmarks (hyrise_tpu_torch/bench/micro.py) on the CPU, beside
the JAX package's (tests/test_periphery.py's BenchmarkRunner case)."""

import json

import numpy as np
import pytest
import torch

from hyrise_tpu.bench.runner import generate_synthetic_table as jax_synthetic_table
from hyrise_tpu_torch.bench import micro
from hyrise_tpu_torch.bench.runner import (BenchmarkConfig, BenchmarkRunner,
                                           generate_synthetic_table)
from hyrise_tpu_torch.expression.ast import col, lit
from hyrise_tpu_torch.ops import TableWrapper, execute_plan
from hyrise_tpu_torch.ops.table_scan import TableScan

torch.set_num_threads(1)


def test_synthetic_table_equals_jax():
    t = generate_synthetic_table(1000, 3, max_value=500, seed=4, device="cpu")
    j = jax_synthetic_table(1000, 3, max_value=500, seed=4)
    assert t.column_names == j.column_names and t.num_rows == j.num_rows == 1000
    assert t.device.type == "cpu"
    for a, b in zip(t.columns, j.columns):
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data)[:1000])


@pytest.mark.parametrize("mode", ["individual", "permuted"])
def test_benchmark_runner(mode):
    t = generate_synthetic_table(1000, 2, device="cpu")

    def q():
        return execute_plan(TableScan(TableWrapper(t), col("column_0") > lit(500)))

    r = BenchmarkRunner(BenchmarkConfig(mode=mode, max_runs=3, warmup_runs=1),
                        {"scan": q, "scan_again": q})
    r.run()
    rep = r.report()
    assert [b["name"] for b in rep["benchmarks"]] == ["scan", "scan_again"]
    for b in rep["benchmarks"]:
        assert b["iterations"] == 3
        assert b["min_time_ms"] <= b["real_time_ms"] <= b["max_time_ms"]
        assert b["real_time_ms"] > 0
    assert rep["context"]["mode"] == mode
    if not torch.cuda.is_available():
        assert rep["context"]["devices"] == ["cpu"]


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        BenchmarkRunner(BenchmarkConfig(mode="bogus"), {"q": lambda: None}).run()


def test_failed_query_leaves_the_others():
    def broken():
        raise RuntimeError("no")

    r = BenchmarkRunner(BenchmarkConfig(max_runs=2, warmup_runs=0),
                        {"broken": broken, "fine": lambda: 1})
    r.run()
    assert [b["name"] for b in r.report()["benchmarks"]] == ["fine"]


def test_write_report_merges_by_name(tmp_path):
    """A partial re-run never shrinks the report: fresh entries win by name,
    old ones stay."""
    path = tmp_path / "report.json"
    first = BenchmarkRunner(BenchmarkConfig(max_runs=1, warmup_runs=0),
                            {"a": lambda: 1, "b": lambda: 2})
    first.run()
    first.write_report(str(path))
    second = BenchmarkRunner(BenchmarkConfig(max_runs=2, warmup_runs=0,
                                             report_path=str(path)),
                             {"b": lambda: 3, "c": lambda: 4})
    second.run()  # writes after every query
    rep = json.loads(path.read_text())
    assert [b["name"] for b in rep["benchmarks"]] == ["a", "b", "c"]
    by_name = {b["name"]: b for b in rep["benchmarks"]}
    assert by_name["a"]["iterations"] == 1 and by_name["b"]["iterations"] == 2


def test_micros_on_the_cpu():
    """Every micro runs as a CompiledQuery on CPU tensors; the table is made,
    the counts scale with k, and no roofline is claimed on the CPU."""
    results = micro.run_micros(rows=2048, runs=3, device="cpu")
    assert [r["name"] for r in results] == list(micro.build_micros(2048, "cpu"))
    for r in results:
        assert r["count_valid"], r
        assert r["chain_ms_per_iter"] > 0
        assert "pct_hbm_roofline" not in r
    assert micro._hbm_peak(torch.device("cpu")) == 0.0


def test_micro_main_writes_the_report(tmp_path):
    out = tmp_path / "micro.json"
    report = micro.main(["--cpu", "--rows", "1024", "--runs", "3", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["context"]["devices"] == ["cpu"]
    assert written["context"]["hbm_peak_gbps"] == 0.0
    names = [b["name"] for b in written["benchmarks"]]
    assert names[-2:] == ["sql_parse_q3", "tpch_dbgen_sf0.1"]
    assert names == [b["name"] for b in report["benchmarks"]]


def test_micro_main_without_a_card_needs_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(SystemExit):
        micro.main(["--rows", "1024"])


def test_micro_peak_names_the_h100():
    assert micro.HBM_PEAK_GBPS == {"H100": 3350.0}

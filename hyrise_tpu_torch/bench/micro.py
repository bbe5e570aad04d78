"""Operator microbenchmarks.

Port of hyrise_tpu/bench/micro.py (reference: src/benchmark/operators/*.cpp,
google-benchmark fixtures for TableScan / JoinHash / JoinSortMerge /
Aggregate / Sort / Projection / UnionAll / Difference and SQL parse and
translate, and src/benchmark/benchmark_main.cpp).

Each micro builds a small physical plan over synthetic tables (the
table_generator.cpp counterpart), runs it as a CompiledQuery
(plan/compiler.py) until its capacities settle, and measures its DEVICE
time by the JAX package's chain protocol, with a CUDA graph where the JAX
package has a fori_loop program:

- a chain of k is k replays of the plan's captured graph, each adding the
  replay's counts (its sites' and its output rows) into one device
  accumulator, between two CUDA
  events; the accumulator is read once, after the chain;
- the execution count is VALIDATED: the summed counts must scale with k
  between k=1 and k=17 before any number is reported (a replay reads the
  same tables, so the ratio is 17 within rounding);
- per-replay ms is the least-squares slope of the median chain time over
  k = 1, 17, 65 (what does not scale with k, the events and the first
  launch, cancels), with a pairwise-slope linearity check;
- the implied GB/s is reported against the card's memory peak only where it
  is physically possible; rows above 100% of that peak publish
  `withheld: true` instead of a roofline figure.

On the CPU (no graph) a chain is k capacity-mode runs of the plan timed on
the host clock, and no roofline is reported, as in the JAX package.

Run: python -m hyrise_tpu_torch.bench.micro [--rows 4194304] [--runs 5]
     [--cpu] [--out micro_report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# device memory peak by card name (NVIDIA's data sheet, H100 SXM); CPU runs
# report no roofline
HBM_PEAK_GBPS = {"H100": 3350.0}


def _hbm_peak(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    for k, v in HBM_PEAK_GBPS.items():
        if k in name:
            return v
    return 0.0


def build_micros(rows: int, device) -> Dict[str, Tuple[Callable, int, int]]:
    """name -> (plan factory, driving rows, bytes touched per pass)."""
    from hyrise_tpu_torch.expression.ast import avg_, col, count_, lit, sum_
    from hyrise_tpu_torch.ops.aggregate import Aggregate
    from hyrise_tpu_torch.ops.get_table import GetTable
    from hyrise_tpu_torch.ops.join import Join
    from hyrise_tpu_torch.ops.misc import Difference, UnionAll
    from hyrise_tpu_torch.ops.projection import Projection
    from hyrise_tpu_torch.ops.sort import Sort
    from hyrise_tpu_torch.ops.table_scan import TableScan
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition as Def
    from hyrise_tpu_torch.types import DataType, JoinMode

    rng = np.random.default_rng(42)
    cat = Catalog()
    n = rows
    m = max(rows // 8, 1024)
    i32, f32 = DataType.INT32, DataType.FLOAT32
    cat.add_table("big", Table.from_arrays(
        "big", [Def("k", i32), Def("v", i32), Def("x", f32), Def("g", i32)],
        [rng.integers(0, m, n).astype(np.int32), rng.integers(0, 10_000, n).astype(np.int32),
         rng.random(n).astype(np.float32), rng.integers(0, 64, n).astype(np.int32)],
        device=device))
    cat.add_table("dim", Table.from_arrays(
        "dim", [Def("dk", i32), Def("dv", f32)],
        [np.arange(m, dtype=np.int32), rng.random(m).astype(np.float32)], device=device))
    cat.add_table("big2", Table.from_arrays(
        "big2", [Def("k", i32), Def("v", i32)],
        [rng.integers(0, m, n).astype(np.int32), rng.integers(0, 10_000, n).astype(np.int32)],
        device=device))

    b4 = 4
    return {
        "table_scan": (
            lambda: TableScan(GetTable("big", cat), col("v") < lit(1000)), n, n * b4),
        "projection": (
            lambda: Projection(GetTable("big", cat),
                               [("y", col("x") * col("x") + lit(1.0))]), n, n * b4),
        "aggregate_64_groups": (
            lambda: Aggregate(GetTable("big", cat), ["g"],
                              [("c", count_()), ("s", sum_(col("x"))),
                               ("a", avg_(col("v")))]), n, n * 3 * b4),
        "aggregate_high_card": (
            lambda: Aggregate(GetTable("big", cat), ["k"], [("s", sum_(col("x")))]),
            n, n * 2 * b4),
        "sort": (lambda: Sort(GetTable("big", cat), ["v", "k"]), n, n * 2 * b4),
        "join_fk": (
            lambda: Join(GetTable("big", cat), GetTable("dim", cat), JoinMode.INNER,
                         ("k", "dk")), n, n * b4 + m * b4),
        "join_semi": (
            lambda: Join(GetTable("big", cat),
                         TableScan(GetTable("dim", cat), col("dk") < lit(m // 2)),
                         JoinMode.SEMI, ("k", "dk")), n, n * b4 + m * b4),
        "union_all": (
            lambda: UnionAll(GetTable("big", cat), GetTable("big", cat)),
            2 * n, 2 * n * 4 * b4),
        "difference": (
            lambda: Difference(Projection(GetTable("big", cat), ["k", "v"]),
                               Projection(GetTable("big2", cat), ["k", "v"])),
            n, 2 * n * 2 * b4),
    }


def bench_sql_frontend(runs: int) -> List[dict]:
    """SQL parse micro (host side; reference src/benchmark/sql_benchmark.cpp)."""
    from hyrise_tpu_torch.sql import parser as P
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL

    sql = TPCH_SQL[3]
    times = []
    for _ in range(max(runs, 20)):
        t0 = time.perf_counter()
        P.parse_sql(sql)
        times.append(time.perf_counter() - t0)
    return [{"name": "sql_parse_q3", "real_time_ms": float(np.median(times) * 1e3),
             "iterations": len(times)}]


def bench_dbgen(sf: float = 0.1, device="cuda") -> List[dict]:
    """TPC-H generator throughput, tables uploaded to `device` (reference
    src/benchmark/tpch_db_generator_benchmark.cpp)."""
    from hyrise_tpu_torch.tpch.dbgen import generate_tables

    t0 = time.perf_counter()
    tables = generate_tables(sf, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    rows = sum(t.num_rows for t in tables.values())
    return [{"name": f"tpch_dbgen_sf{sf:g}", "real_time_ms": dt * 1e3, "iterations": 1,
             "rows_per_second": rows / dt}]


def make_chain(cq) -> Callable[[int], Tuple[float, int]]:
    """run(k) -> (ms, summed site counts) of k executions of the settled
    plan: k replays of its captured graph between two CUDA events on the
    card, k capacity-mode runs on the host clock on the CPU."""
    if not cq.on_cuda:
        def run_cpu(k: int):
            t0 = time.perf_counter()
            total = 0
            for _ in range(k):
                total += int(cq._execute(learning=False)[2].sum())
            return (time.perf_counter() - t0) * 1e3, total
        return run_cpu

    graph, counts = cq._graph, cq._graph_outputs[2]
    acc = torch.zeros((), dtype=torch.int64, device=cq.device)

    def run_cuda(k: int):
        acc.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            graph.replay()
            acc.add_(counts.sum())
        end.record()
        end.synchronize()
        return start.elapsed_time(end), int(acc)
    return run_cuda


def chain_slope(run_fn, label, ks=(1, 17, 65), n=5):
    """Per-iteration ms from a least-squares fit of the median chain time
    against k (the JAX package's protocol: what does not scale with k is
    the intercept; the pairwise slopes must agree within 25% or the fit is
    made once more and flagged)."""
    def med_time(k):
        return sorted(run_fn(k)[0] for _ in range(n))[n // 2]

    run_fn(ks[0])
    run_fn(ks[0])  # warm
    lin_ok, slope = False, 0.0
    for _ in range(2):
        meds = [med_time(k) for k in ks]
        kbar = sum(ks) / len(ks)
        tbar = sum(meds) / len(meds)
        slope = (sum((k - kbar) * (t - tbar) for k, t in zip(ks, meds))
                 / sum((k - kbar) ** 2 for k in ks))
        s01 = (meds[1] - meds[0]) / (ks[1] - ks[0])
        s12 = (meds[2] - meds[1]) / (ks[2] - ks[1])
        lin_ok = min(s01, s12) > 0 and abs(s01 - s12) / max(s01, s12) < 0.25
        print(f"{label} chain fit: meds={[round(t, 4) for t in meds]}ms at k={list(ks)}; "
              f"slope={slope:.4f}ms/iter ({'linear' if lin_ok else 'NON-LINEAR'})",
              file=sys.stderr)
        if lin_ok:
            break
    return max(slope, 1e-6), lin_ok


def run_micros(rows: int, runs: int, device, out=sys.stderr) -> List[dict]:
    """Every micro of build_micros on `device`: one entry each, printed as a
    table row to `out`."""
    from hyrise_tpu_torch.plan.compiler import CompiledQuery

    device = torch.device(device)
    peak = _hbm_peak(device)
    results = []
    kmid = 17
    for name, (factory, drive_rows, touched) in build_micros(rows, device).items():
        t0 = time.perf_counter()
        cq = CompiledQuery(factory())
        prev = None
        for _ in range(6):  # until the capacities settle
            cq.run()
            if prev == tuple(cq.caps):
                break
            prev = tuple(cq.caps)
        run_chain = make_chain(cq)
        v1 = run_chain(1)[1]
        compile_s = time.perf_counter() - t0
        ratio = run_chain(kmid)[1] / max(v1, 1)
        count_valid = kmid * 0.97 < ratio < kmid * 1.03
        slope_ms, lin_ok = chain_slope(run_chain, name, n=runs)
        entry = {
            "name": name,
            "chain_ms_per_iter": slope_ms,
            "count_validation_ratio": ratio,
            "count_valid": bool(count_valid),
            "linear_fit": bool(lin_ok),
            "compile_s": compile_s,
            "rows_per_second": drive_rows / (slope_ms / 1e3),
            "bytes_touched": touched,
            "effective_gbps": touched / (slope_ms / 1e3) / 1e9,
        }
        status = ""
        if not (count_valid and lin_ok):
            # the measurement failed its own checks: the raw fit, flagged,
            # and no roofline claim
            entry["withheld"] = True
            entry.pop("rows_per_second")
            entry.pop("effective_gbps")
            status = "  [WITHHELD: integrity checks failed]"
        elif peak:
            pct = 100.0 * entry["effective_gbps"] / peak
            if pct > 100.0:
                entry["withheld"] = True
                entry["withheld_reason"] = (
                    f"implied {entry['effective_gbps']:.0f}GB/s exceeds the documented "
                    f"{peak:.0f}GB/s peak")
                status = f"  [WITHHELD: {pct:.0f}% of documented peak]"
            else:
                entry["pct_hbm_roofline"] = pct
                status = f"  {pct:5.1f}% of HBM roofline"
        results.append(entry)
        print(f"{name:22s} {slope_ms:9.4f}ms/iter  "
              f"{drive_rows / (slope_ms / 1e3) / 1e9:7.3f}B rows/s  "
              f"{touched / (slope_ms / 1e3) / 1e9:7.1f}GB/s  "
              f"v({kmid})/v(1)={ratio:.2f}{status}", file=out)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU tensors (the default device is the card)")
    ap.add_argument("--out", default="micro_report.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("micro: no CUDA device; pass --cpu to run on CPU tensors")
    from hyrise_tpu_torch.bench.runner import devices

    results = run_micros(args.rows, args.runs, device)
    results += bench_sql_frontend(args.runs)
    results += bench_dbgen(device=device)
    report = {
        "context": {
            "devices": devices() if device.type == "cuda" else ["cpu"],
            "rows": args.rows,
            "hbm_peak_gbps": _hbm_peak(device),
            "protocol": "k replays of the captured graph between CUDA events, "
                        "count-validated, slope fit over k=(1,17,65)",
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        },
        "benchmarks": results,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()

"""Where a TPC-H query's time goes on the card.

For each query asked for: generate the tables at scale factor SF on the
CUDA device (seed SEED), run the plan five times without the profiler, then once
under torch.profiler. Prints, per query, one JSON line with the wall ms of the
query without the profiler (median of 3 runs, host clock, to rows on the
host), the wall ms under the profiler (which slows the host side), the
device-busy ms (sum of the kernels' device time), the idle share
(1 - busy / wall without the profiler), the operators' wall times as the
profiled plan reports them, the hand-written kernels' launch counts and
every device kernel with its total time, the longest first.

Run:  python -m hyrise_tpu_torch.profile_query 9 18 21
It fails when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from hyrise_tpu_torch.kernels.prims import (expand_pairs, lookup_last_eq_lut,
                                            segment_reduce_cells)
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch import dbgen
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

SF = 1.0
SEED = 19940607
_WRAPPERS = {"segment_reduce_cells": segment_reduce_cells,
             "lookup_last_eq_lut": lookup_last_eq_lut, "expand_pairs": expand_pairs}


def _operators(root: AbstractOperator):
    """(name, wall ms) of every operator of the plan, inputs first."""
    seen, out = set(), []

    def walk(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.inputs:
            walk(i)
        out.append((op.name, round(op.performance_data.walltime_s * 1e3, 3)))

    walk(root)
    return out


def profile(qid: int, catalog: Catalog) -> dict:
    walls = []
    for _ in range(5):  # two warm-up runs, three timed
        t0 = time.perf_counter()
        execute_plan(TPCH_PLANS[qid](catalog)).rows()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls[2:])
    for w in _WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        # building a plan already runs its scalar subqueries (Q11, Q22)
        plan = TPCH_PLANS[qid](catalog)
        rows = execute_plan(plan).rows()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            # torch renamed self_cuda_time_total to self_device_time_total
            total_us = getattr(avg, "self_device_time_total", None)
            if total_us is None:
                total_us = avg.self_cuda_time_total
            kernels[avg.key] = (total_us / 1e3, avg.count)
    busy_ms = sum(t for t, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"query": qid, "rows": len(rows), "wall_ms": round(wall_ms, 3),
            "profiled_wall_ms": round(profiled_ms, 3), "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": round(1 - busy_ms / wall_ms, 4),
            "device_kernels": sum(c for _, c in kernels.values()),
            "launches": {k: w.launches for k, w in _WRAPPERS.items()},
            "operators": _operators(plan),
            "kernels": [{"name": name[:90], "ms": round(t, 3), "calls": c}
                            for name, (t, c) in ranked]}


def main() -> None:
    queries = [int(a) for a in sys.argv[1:]]
    if not queries or any(q not in TPCH_PLANS for q in queries):
        raise SystemExit("usage: python -m hyrise_tpu_torch.profile_query QUERY [QUERY ...]"
                         f"  (of {min(TPCH_PLANS)} to {max(TPCH_PLANS)})")
    if not torch.cuda.is_available():
        raise SystemExit("profile_query: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    catalog = Catalog()
    for name, t in dbgen.generate_tables(SF, SEED, device="cuda").items():
        catalog.add_table(name, t)
    for qid in queries:
        print(json.dumps({"card": card, "sf": SF, **profile(qid, catalog)}), flush=True)


if __name__ == "__main__":
    main()

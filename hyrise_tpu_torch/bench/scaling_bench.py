"""Rows a second of the distributed compiled TPC-H queries over 1, 2, 4 and
8 shards, and the efficiency of each against one shard.

Port of scripts/scaling_bench.py. Each mesh holds every shard in this
process on one device (the card unless the caller asks for the CPU):
`shard_tpch` places the tables, and each query runs as a
DistributedCompiledQuery (parallel/dist_compiler.py), every shard and
exchange in one CUDA graph, replayed. The shards share that one device and
no interconnect is crossed, so the curve measures what the exchanges and
the per-shard work cost on one card, not a multi-card speed-up. Each
mesh's answer is held against the one-shard answer (ints and strings
equal, floats within 1e-6 relative, in order).

    python -m hyrise_tpu_torch.bench.scaling_bench [--sf 0.2] [--runs 5]
        [--queries 1,3,6,12] [--meshes 1,2,4,8] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Iterable

import torch

NOTE = ("every shard of a mesh is held by one process on one device: the shards share "
        "that device and no interconnect is crossed")


def run_scaling(cat, qids: Iterable[int], meshes: Iterable[int], runs: int, device,
                log=None, on_query=None) -> dict:
    """{"context": ..., "queries": {qid: {n: {"median_ms", "rows_per_s",
    "efficiency_vs_1_shard", "answer_equal"}}}} over `cat`'s tables, each
    mesh of n shards on `device`. A query's first run learns and captures;
    `runs` replays are timed (host clock to the result table, the device
    synchronized). `on_query`, where given, is called with each
    DistributedCompiledQuery after its runs (for its launch counts)."""
    from hyrise_tpu_torch.bench.runner import devices
    from hyrise_tpu_torch.parallel.dist_compiler import DistributedCompiledQuery, shard_tpch
    from hyrise_tpu_torch.parallel.mesh import Mesh
    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS
    from hyrise_tpu_torch.utils.table_eq import tables_equal

    device = torch.device(device)
    qids, meshes = list(qids), list(meshes)
    driving_rows = int(cat.get_table("lineitem").num_rows)
    report = {"context": {"driving_rows": driving_rows, "meshes": meshes,
                          "devices": devices() if device.type == "cuda" else ["cpu"],
                          "shards_share_one_device": True, "note": NOTE},
              "queries": {qid: {} for qid in qids}}
    first_rows = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for n in meshes:
        t0 = time.perf_counter()
        sc = shard_tpch(cat, Mesh([device] * n))
        sync()
        shard_s = time.perf_counter() - t0
        for qid in qids:
            dq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc)
            rows = dq.run().rows()
            times = []
            for _ in range(runs):
                t1 = time.perf_counter()
                out = dq.run()
                sync()
                times.append(time.perf_counter() - t1)
            rows_again = out.rows()
            base_rows = first_rows.setdefault(qid, rows)
            equal = all(tables_equal(r, base_rows, ordered=True, rel_tol=1e-6, abs_tol=0.0)[0]
                        for r in (rows, rows_again))
            med = statistics.median(times)
            entry = {"median_ms": med * 1e3, "rows_per_s": driving_rows / med,
                     "answer_equal": equal, "captures": dq.captures,
                     "last_retries": dq.last_retries, "shard_s": shard_s}
            base = report["queries"][qid].get(meshes[0])
            entry["efficiency_vs_1_shard"] = None if base is None else \
                entry["rows_per_s"] / (base["rows_per_s"] * n / meshes[0])
            report["queries"][qid][n] = entry
            if log is not None:
                eff = entry["efficiency_vs_1_shard"]
                log(f"Q{qid:02d} n={n}: {med * 1e3:.3f} ms, {entry['rows_per_s'] / 1e6:.2f} "
                    f"Mrows/s" + ("" if eff is None else f", efficiency {eff:.3f}")
                    + ("" if equal else ", ANSWER DIFFERS"))
            if on_query is not None:
                on_query(dq)
            del dq
        del sc
    return report


def main(argv=None) -> dict:
    from hyrise_tpu_torch.bench.tpch_bench import (default_out, load_catalog, make_parent,
                                                   resolve_device)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=0.2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="1,3,6,12")
    ap.add_argument("--meshes", default="1,2,4,8")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("scaling_report.json"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    cat = load_catalog(args.sf, device)
    print(f"generated SF{args.sf} on {device} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    report = run_scaling(cat, [int(q) for q in args.queries.split(",")],
                         [int(m) for m in args.meshes.split(",")], args.runs, device,
                         log=lambda line: print(line, file=sys.stderr))
    report["context"]["sf"] = args.sf
    make_parent(args.out)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"-> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()

"""The 22-query TPC-H suite into a google-benchmark-style JSON report.

Port of scripts/tpch_bench.py (reference: the hyriseBenchmarkTPCH binary,
src/benchmark/tpch_benchmark.cpp), through the port's BenchmarkRunner
(bench/runner.py): each query is warmed up, then run `--runs` times, and
its median, minimum and maximum host ms (to the result on the device) go
into the report. On the card the report's context names the card and its
power limit, as nvidia-smi gives them.

    python -m hyrise_tpu_torch.bench.tpch_bench [--sf 1] [--runs 3] [--warmup 1]
        [--queries 1,3,6] [--via plans|sql|compiled|sql-compiled|blocked|segmented|
                                 compiled-blocked|compiled-segmented]
        [--block-rows N] [--resident-rows N]
        [--encoding none|dictionary|run_length|for] [--device cuda|cpu] [--out PATH]

`--via`: the hand plans eagerly (`plans`), the SQL pipeline (`sql`), the
plans as CompiledQuerys (`compiled`: one CUDA graph a query, replayed), the
SQL pipeline with compiled execution (`sql-compiled`), the streamed forms
(`blocked`, `segmented`, and their compiled forms): tpch/queries.py's
run_query. The tables are generated on `--device` (default `cuda`; a
machine without CUDA needs `--device cpu`). The JAX script's `--fastpath`
and `--cap-cache` seed XLA's capacities and have no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional

import torch

VIAS = ("plans", "sql", "compiled", "sql-compiled", "blocked", "segmented",
        "compiled-blocked", "compiled-segmented")
ENCODINGS = ("none", "dictionary", "run_length", "for")
# reports go under this directory of the working directory (git ignores it)
REPORT_DIR = "bench_reports"


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on: the card unless the caller names the CPU;
    `cuda` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on CPU tensors")
    return device


def default_out(name: str) -> str:
    return os.path.join(REPORT_DIR, name)


def make_parent(path: str) -> None:
    """Create the directory a report is written into."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def load_catalog(sf: float, device, encoding: str = "none"):
    """TPC-H at `sf` generated on `device` into a new Catalog, every
    column encoded at rest with `encoding` where it suits."""
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.tpch.dbgen import generate_tables

    tables = generate_tables(sf, device=device)
    if encoding != "none":
        from hyrise_tpu_torch.storage.encoding import ChunkEncoder, EncodingType
        spec = {"dictionary": EncodingType.DICTIONARY, "run_length": EncodingType.RUN_LENGTH,
                "for": EncodingType.FRAME_OF_REFERENCE}[encoding]
        tables = {name: ChunkEncoder.encode_table(t, spec) for name, t in tables.items()}
    cat = Catalog()
    for name, t in tables.items():
        cat.add_table(name, t)
    return cat


def make_queries(cat, qids: Iterable[int], via: str, block_rows: int = 1 << 22,
                 resident_rows: int = 1 << 24) -> Dict[str, Callable[[], object]]:
    """{"TPC-H NN": a call that runs query NN once over `cat`, `via` one
    execution form}. The compiled forms are kept on the catalog, so every
    call after the first replays; `sql-compiled` keeps its statement in the
    pipeline's compiled cache."""
    from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL, run_query

    if via not in VIAS:
        raise ValueError(f"via must be one of {VIAS}, got {via!r}")

    def one(qid: int):
        if via in ("sql", "sql-compiled"):
            def run():
                builder = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat)
                if via == "sql-compiled":
                    builder = builder.with_compiled_execution()
                return builder.create_pipeline().get_result_table()
            return run
        return lambda: run_query(qid, cat, via=via, block_rows=block_rows,
                                 resident_rows=resident_rows)

    return {f"TPC-H {qid:02d}": one(qid) for qid in qids}


def run_suite(cat, qids: Iterable[int], via: str = "plans", runs: int = 3, warmup: int = 1,
              sf: float = 1.0, out: Optional[str] = None, block_rows: int = 1 << 22,
              resident_rows: int = 1 << 24, verbose: bool = False,
              max_duration_s: float = 600.0) -> dict:
    """Run the queries over `cat` through the BenchmarkRunner and return its
    report (written to `out`, merged by query name, where given)."""
    from hyrise_tpu_torch.bench.runner import BenchmarkConfig, BenchmarkRunner

    qids = list(qids)
    config = BenchmarkConfig(mode="individual", max_runs=runs, warmup_runs=warmup,
                             max_duration_s=max_duration_s, verbose=verbose,
                             scale_factor=sf, report_path=out or "",
                             context={"via": via, "tables_on": str(
                                 cat.get_table(cat.table_names()[0]).device)})
    runner = BenchmarkRunner(config, make_queries(cat, qids, via, block_rows, resident_rows))
    runner.run()
    if out:
        runner.write_report(out)
    return runner.report()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--queries", default=None, help="comma-separated ids (default: all 22)")
    ap.add_argument("--via", choices=VIAS, default="plans")
    ap.add_argument("--block-rows", type=int, default=1 << 22,
                    help="rows a stream block, for the blocked and segmented forms")
    ap.add_argument("--resident-rows", type=int, default=1 << 24,
                    help="tables of more rows stream under the segmented forms")
    ap.add_argument("--encoding", choices=ENCODINGS, default="none",
                    help="the at-rest encoding of every column it suits")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("tpch_report.json"))
    args = ap.parse_args(argv)

    from hyrise_tpu_torch.tpch.queries import TPCH_PLANS

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    cat = load_catalog(args.sf, device, args.encoding)
    print(f"generated SF{args.sf} on {device} in {time.perf_counter() - t0:.1f} s"
          + ("" if args.encoding == "none" else f", encoded {args.encoding}"), file=sys.stderr)
    qids = [int(q) for q in args.queries.split(",")] if args.queries else sorted(TPCH_PLANS)
    make_parent(args.out)
    report = run_suite(cat, qids, args.via, args.runs, args.warmup, args.sf, args.out,
                       args.block_rows, args.resident_rows, verbose=True)
    total = sum(b["real_time_ms"] for b in report["benchmarks"])
    print(f"total (sum of medians): {total:.1f} ms across {len(report['benchmarks'])} "
          f"queries -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()

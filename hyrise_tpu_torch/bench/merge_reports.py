"""Merge benchmark reports (bench/runner.py's JSON): a later file wins per
query name, and the context comes from the last file that has one.

Port of scripts/merge_reports.py, for stitching partial runs of the TPC-H
suite (bench/tpch_bench.py --queries ...) into one report.

    python -m hyrise_tpu_torch.bench.merge_reports OUT IN1 IN2 [IN3 ...]
"""

from __future__ import annotations

import json
import sys
from typing import Sequence


def merge(paths: Sequence[str]) -> dict:
    merged, context = {}, None
    for path in paths:
        with open(path) as f:
            rep = json.load(f)
        context = rep.get("context", context)
        for b in rep.get("benchmarks", []):
            merged[b["name"]] = b
    return {"context": context, "benchmarks": [merged[k] for k in sorted(merged)]}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m hyrise_tpu_torch.bench.merge_reports OUT IN1 [IN2 ...]")
    out, ins = argv[0], argv[1:]
    report = merge(ins)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    total = sum(b["real_time_ms"] for b in report["benchmarks"])
    print(f"{out}: {len(report['benchmarks'])} queries, total {total:.0f}ms")
    return report


if __name__ == "__main__":
    main()

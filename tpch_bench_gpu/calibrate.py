"""The readings that the limits of `correct` are set from, on the card.

    python3 -m tpch_bench_gpu.calibrate --workload <name> --seeds 1,2,3 --seconds 10 [--out F]

For each seed, in one process: one run of the cell (its set-up, a short
window at the cell's own load, the check against the reference), which
gives the program's readings (left out with --control-only, where the
cell's own runs give them); then the control, the plain reference computed
in the nearest precision below the configuration's (float32 where SUM and
AVG accumulate in float64), compared with the float64 reference on the same
data, which gives the control's readings. Each seed's line is printed and
appended to --out as JSON.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from tpch_bench_gpu import harness
from tpch_bench_gpu.compare import compare, sorted_answer
from tpch_bench_gpu.reference.common import Data


def control(specs: dict, qids, device, low=torch.float32) -> dict:
    """The reference in `low` precision against the reference in float64:
    the widest float gap and the exact mismatches, per query and in all."""
    data = Data(specs, device)
    per_query = {}
    for q in qids:
        module = harness.reference_module(q)
        ref = module.answer(data, torch.float64)
        ctl = sorted_answer(module.answer(data, low), module.ORDER_BY)
        per_query[q] = compare(ctl.columns, ref, module.ORDER_BY)
    del data
    return {"exact_mismatches": sum(m for m, _ in per_query.values()),
            "float_rel_err_max": max(e for _, e in per_query.values()),
            "per_query": {f"q{q:02d}": list(v) for q, v in per_query.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--control-only", action="store_true",
                    help="generate the data and read the control alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.prepare(args.workload, seed)
        line = {"workload": args.workload, "seed": seed}
        if not args.control_only:
            out = harness.run_prepared(cell, args.seconds, False, "cuda", log=lambda *a: None)
            gc.collect()
            line.update(correct=out["correct"],
                        program={k: out["checks"][k]["value"]
                                 for k in ("exact_mismatches", "float_rel_err_max",
                                           "answers_compared")})
        line.update(control=control(cell.specs, sorted(cell.sqls), "cuda"),
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

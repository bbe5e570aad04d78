"""The benchmark's command: one run of one cell on the card.

    python3 -m tpch_bench_gpu.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (hyrise_tpu_torch)
beside BENCHMARK.json. It refuses to run without as many CUDA devices as the
cell asks for. Its last line on standard output is one JSON object: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, the device's busy seconds and a breakdown. The numbers that decide
`correct` are the last lines on standard error and the last key of that
object. Exit codes: 0 a result was printed (correct or not), 2 bad
arguments, 3 no card, 4 a forbidden module was loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here  # noqa: E402

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None, help="write every request's record here (analysis)")
    args = ap.parse_args(argv)

    import torch

    from tpch_bench_gpu import harness

    wl, _, _ = harness.cell(harness.bench_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0, dump=args.dump)
    loaded = harness.forbidden_modules()
    if loaded:
        print("forbidden modules loaded: " + ", ".join(loaded), file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""warm_capture_s: seconds of the program's `compiled.capture` spans in set-up
(before the window's first request), a part of setup_s's warm runs
(program_spans.py); nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.setup_s(run, "compiled.capture")

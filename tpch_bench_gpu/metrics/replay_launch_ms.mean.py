"""replay_launch_ms.mean: the host's launch of a captured graph's replay, from
the program's `compiled.replay` spans: a request's summed durations averaged
over the window's completed requests (program_spans.py); nothing without the
program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "compiled.replay")

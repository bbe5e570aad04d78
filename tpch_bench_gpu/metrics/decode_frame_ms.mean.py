"""decode_frame_ms.mean: the pandas DataFrame built from the decoded columns,
from the program's `decode.frame` spans: a request's summed durations
averaged over the window's completed requests (program_spans.py); nothing
without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.frame")

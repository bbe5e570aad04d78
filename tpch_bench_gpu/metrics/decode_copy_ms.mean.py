"""decode_copy_ms.mean: the result's device-to-host copies (live mask or row
count, data, validity), from the program's `decode.copy` spans: a request's
summed durations averaged over the window's completed requests
(program_spans.py); nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.copy")

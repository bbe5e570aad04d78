"""decode_strings_ms.mean: dictionary codes turned into Python strings and
NULLs filled in, from the program's `decode.strings` spans: a request's
summed durations averaged over the window's completed requests
(program_spans.py); nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.strings")

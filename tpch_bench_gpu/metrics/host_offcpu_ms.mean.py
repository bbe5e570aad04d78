"""host_offcpu_ms.mean: wall minus thread CPU time over a request's
host-only program spans (parse, translate, optimize, plan,
compiled.replay, decode.strings, decode.frame), averaged over the window's
completed requests: time the client's thread waited for the interpreter
lock or a core (program_spans.py); nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.offcpu_ms(run)

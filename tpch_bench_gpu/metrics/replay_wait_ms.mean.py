"""replay_wait_ms.mean: waiting for a CompiledQuery's lock while another client
replays the same text, from the program's `compiled.wait` spans: a request's
summed durations averaged over the window's completed requests
(program_spans.py); nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "compiled.wait")

"""replay_read_ms.mean: the host read of a replay's counts, which waits for the
device, from the program's `compiled.read` spans: a request's summed
durations averaged over the window's completed requests (program_spans.py);
nothing without the program's spans."""

from tpch_bench_gpu import program_spans


def read(run):
    return program_spans.mean_ms(run, "compiled.read")

"""The program's spans and the device trace on one clock: a span recorded
around a sleep kernel and a synchronize, moved onto the torch.profiler
(CUPTI) clock by the offset the harness takes at a window's start, holds the
kernel's interval to within 20 us at each end. On the card:

    python3 -m pytest tpch_bench_gpu/tests/test_program_spans_clock.py -m card -s
"""

import time

import pytest
import torch

from tpch_bench_gpu import trace

SLACK_NS = 20_000


@pytest.mark.card
def test_a_span_holds_its_kernel_on_the_trace_clock(card):
    from torch.profiler import ProfilerActivity, profile

    from hyrise_tpu_torch.utils import spans

    torch.cuda._sleep(1_000)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_offset = time.time_ns() - time.perf_counter_ns()  # as harness._window takes it
        with spans.recording():
            for _ in range(5):
                with spans.span("sleep"):
                    torch.cuda._sleep(20_000_000)  # cycles: about 10 ms
                    torch.cuda.synchronize(card)
                time.sleep(0.01)
    recorded = [s for s in spans.drain() if s.name == "sleep"]
    kernels = sorted(e for e in trace.device_events(prof) if e[1] - e[0] > 1_000_000)
    assert len(recorded) == len(kernels) == 5
    for s, (a, b, name) in zip(recorded, kernels):
        start, end = s.t0 + wall_offset, s.t1 + wall_offset
        print(f"{name}: kernel starts {(a - start) / 1e3:.3f} us after the span, "
              f"ends {(end - b) / 1e3:.3f} us before it ({(b - a) / 1e6:.3f} ms)")
        assert start - SLACK_NS <= a and b <= end + SLACK_NS

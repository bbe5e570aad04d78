"""Reading the device trace of a traced run (`--trace 1`).

`torch.profiler` with CUDA activity only records every kernel, copy and
memset the card ran (CUPTI). Its timestamps are nanoseconds of the host's
wall clock (`time.time_ns()`), so the benchmark's own host spans, kept on
`time.perf_counter_ns()`, are moved onto that clock by one offset taken at
the window's start.

From the device intervals inside the window [start, end]:
- `busy_s`: the length of their union (several clients' work may overlap);
- `device_ops`: the ten names that took most device time;
- `idle_gaps`: the ten longest stretches with nothing on the device, each
  named by the host span every client had open at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]  # [start, end) in ns


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    events: int


def device_events(prof) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of every device activity of a finished
    torch.profiler run."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name()))
    return out


def union(intervals: Sequence[Interval], start: int, end: int) -> List[Interval]:
    """The union of `intervals` clipped to [start, end), as sorted disjoint
    intervals."""
    merged: List[list] = []
    for a, b in sorted(intervals):
        a, b = max(a, start), min(b, end)
        if a >= b:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def gaps(busy: Sequence[Interval], start: int, end: int) -> List[Interval]:
    out, at = [], start
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if end > at:
        out.append((at, end))
    return out


def span_at(spans: Sequence[Tuple[int, int, str]], starts: Sequence[int], t: int) -> str:
    """The label of the span of one client (sorted, disjoint) open at t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return "none"


def read(events: Sequence[Tuple[int, int, str]], start: int, end: int,
         client_spans: Sequence[Sequence[Tuple[int, int, str]]], top: int = 10) -> Trace:
    """The trace's summary over the window [start, end) (ns, wall clock);
    `client_spans` holds each client's host spans (start, end, label)."""
    busy = union([(a, b) for a, b, _ in events], start, end)
    by_name: Dict[str, int] = {}
    for a, b, name in events:
        a, b = max(a, start), min(b, end)
        if a < b:
            by_name[name] = by_name.get(name, 0) + b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = [sorted(s) for s in client_spans]
    starts = [[a for a, _, _ in s] for s in spans]
    named = []
    for a, b in sorted(gaps(busy, start, end), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        label = "; ".join(f"c{i + 1} {span_at(s, st, mid)}"
                          for i, (s, st) in enumerate(zip(spans, starts)))
        named.append([label, (b - a) / 1e9])
    return Trace(busy_s=sum(b - a for a, b in busy) / 1e9, window_s=(end - start) / 1e9,
                 device_ops=[[name[:160], ns / 1e9] for name, ns in ops],
                 idle_gaps=named, events=len(events))

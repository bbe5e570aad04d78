"""The program's own spans in a traced run, for the per-layer metrics that
read them (metrics/replay_*.py, decode_*.py, host_offcpu_ms.mean.py,
warm_*.py) and for naming the device's idle gaps.

The port records spans (hyrise_tpu_torch/utils/spans.py) at its layer
boundaries: `statement` with `parse`, `translate`, `optimize`, `plan` and
`execute`; under `execute` the `compiled.*` steps of a CompiledQuery run;
`decode` with `decode.copy`, `decode.strings` and `decode.frame` around
Table.to_pandas. Each carries the id of the statement it serves, its start
and end on `time.perf_counter_ns()` (the clock of the harness's stamps) and
the thread's CPU time at both.

What a reader expects of the run: `run.spans`, every span the program
recorded from before upload to the window's end, and on each request
`statement`, its statement's span id (StatementMetrics.span_id). A run
without them (the recorder off, or a harness that does not hand them over)
gives None from every reader here, and `client_spans` gives the request
spans it was handed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int, str]  # [start, end) in ns, label

# spans of host-only work: wall minus CPU time there is time the thread
# waited for the interpreter lock or a core. Not compiled.read, decode.copy
# or execute's synchronize: a CUDA wait may spin on the CPU.
HOST_ONLY = ("parse", "translate", "optimize", "plan", "compiled.replay", "decode.strings",
             "decode.frame")


def _spans(run) -> Optional[list]:
    return getattr(run, "spans", None) or None


def per_request_ms(run, names: Sequence[str],
                   value: Callable[[object], int] = lambda s: s.t1 - s.t0) -> Optional[float]:
    """The sum of `value` (ns) over a request's spans named in `names`,
    averaged over the window's completed requests (0 for a request with
    none), in ms; None without spans or without requests that carry their
    statement's id."""
    spans, done = _spans(run), run.completed
    if spans is None or not done or all(getattr(r, "statement", None) is None for r in done):
        return None
    by_statement: Dict[int, int] = {}
    for s in spans:
        if s.name in names:
            by_statement[s.statement] = by_statement.get(s.statement, 0) + value(s)
    return sum(by_statement.get(getattr(r, "statement", None), 0) for r in done) / len(done) / 1e6


def mean_ms(run, name: str) -> Optional[float]:
    """A request's time in spans named `name`, averaged (per_request_ms)."""
    return per_request_ms(run, (name,))


def offcpu_ms(run) -> Optional[float]:
    """A request's wall minus thread CPU time over its host-only spans,
    averaged (per_request_ms)."""
    return per_request_ms(run, HOST_ONLY, lambda s: (s.t1 - s.t0) - (s.c1 - s.c0))


def setup_s(run, name: str) -> Optional[float]:
    """The seconds of spans named `name` that ended before the window's
    first request was issued: set-up's."""
    spans = _spans(run)
    if spans is None or not run.requests:
        return None
    start = min(r.t_issue for r in run.requests) * 1e9
    return sum(s.t1 - s.t0 for s in spans if s.name == name and s.t1 <= start) / 1e9


def innermost(intervals: Sequence[Interval]) -> List[Interval]:
    """Nested or disjoint intervals cut into disjoint pieces, each labelled
    by the innermost interval open there, in order."""
    out: List[Interval] = []
    stack: List[Interval] = []
    at = 0

    def cut(end: int) -> None:
        nonlocal at
        if stack and end > at:
            out.append((at, end, stack[-1][2]))
        at = max(at, end)

    for a, b, label in sorted(intervals, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            cut(stack[-1][1])
            stack.pop()
        cut(a)
        stack.append((a, b, label))
    while stack:
        cut(stack[-1][1])
        stack.pop()
    return out


def _uncovered(intervals: Sequence[Interval], cover: Sequence[Interval]) -> List[Interval]:
    """The parts of sorted disjoint `intervals` that sorted disjoint `cover`
    leaves open."""
    out, j = [], 0
    for a, b, label in intervals:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k, at = j, a
        while k < len(cover) and cover[k][0] < b:
            if cover[k][0] > at:
                out.append((at, cover[k][0], label))
            at = max(at, cover[k][1])
            k += 1
        if at < b:
            out.append((at, b, label))
    return out


def client_spans(requests, spans, request_spans: Sequence[Sequence[Interval]],
                 wall_offset: int) -> List[List[Interval]]:
    """Each client's host spans for naming the idle gaps (trace.read): the
    innermost program span of its request's statement, as
    "<span> q<NN>", and the harness's request spans (`request_spans`, one
    list a client) where none was open. Clock: the trace's (wall_offset
    added to perf_counter ns)."""
    if not spans:
        return [sorted(s) for s in request_spans]
    of = {r.statement: r for r in requests if getattr(r, "statement", None) is not None}
    mine: List[List[Interval]] = [[] for _ in request_spans]
    for s in spans:
        r = of.get(s.statement)
        if r is not None:
            mine[r.client].append((s.t0 + wall_offset, s.t1 + wall_offset,
                                   f"{s.name} q{r.qid:02d}"))
    out = []
    for program, fallback in zip(mine, request_spans):
        cut = innermost(program)
        out.append(sorted(cut + _uncovered(sorted(fallback), cut)))
    return out

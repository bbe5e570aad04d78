"""Spans: where a statement's time goes, recorded at the port's layer
boundaries.

A span is one stretch of work on one thread: its name, its own id, the id
of the span that was open around it on that thread (its parent), the id of
the statement it serves, its start and end on `time.perf_counter_ns()`
(`t0`, `t1`), and a few attributes: integers (`rows`, `bytes`, `position`)
or a word (`cache` of a string decode: `hit`, `build` or `direct`).
A span of host-only work (`cpu=True`: the front end's stages, a graph's
launch, the strings and the frame of a decode) also holds the thread's CPU
time `time.thread_time_ns()` at both ends (`c0`, `c1`; else None): wall
minus CPU time there is time the thread waited for the interpreter lock or
a core. Only there, because that clock can be slow (2.4 us a read on the
host of an NVIDIA H100 machine, where `perf_counter_ns` took 53 ns), and
where a CUDA wait may spin, wall minus CPU time says nothing anyway.

The recorder is off until `enable()` turns it on; there is no setting or
environment variable for it. While off, `span()` costs one check of a module
flag: no clock is read and nothing is allocated. While on, each thread keeps
its finished spans in memory until `drain()` hands over every thread's and
forgets them. It keeps them as tuples of numbers and strings, which the
garbage collector stops tracking, so that a long recording adds no pauses
of its own to the program's.

    from hyrise_tpu_torch.utils import spans
    with spans.recording():
        table = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline() \\
            .get_result_table()
        frame = table.to_pandas()
    for s in spans.drain():
        print(s.name, s.statement, s.parent, s.seconds)

`span(name)` marks work recorded only while on; `stage(name)` marks work
timed always (StatementMetrics' stages), whose span is recorded while on
from the same two stamps, so the two always agree. The names the port
records: `statement` (its children `parse`, `translate`, `optimize`, `plan`,
`execute`), under `execute` the `compiled.*` steps of plan/compiler.py's
CompiledQuery.run or one span an eager operator (its `name`), then
`execute.sync` (the wait for the device on a CUDA result), and
`decode` with `decode.copy`, `decode.strings` and `decode.frame` where a
result is read to the host.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional

_on = False  # the recorder's one flag, read by span() and stage()
_ids = itertools.count(1)
_local = threading.local()
_threads: list = []  # every recording thread's _Thread, for drain()
_threads_lock = threading.Lock()


class _Thread:
    """One thread's open spans (innermost last) and finished ones (as
    Span._record tuples)."""

    __slots__ = ("name", "ref", "stack", "done")

    def __init__(self, thread: threading.Thread):
        self.name = thread.name
        self.ref = weakref.ref(thread)
        self.stack: List[Span] = []
        self.done: List[tuple] = []


def _thread() -> _Thread:
    t = getattr(_local, "t", None)
    if t is None:
        t = _local.t = _Thread(threading.current_thread())
        with _threads_lock:
            _threads.append(t)
    return t


class Span:
    """One recorded stretch of work; a context manager. While the recorder
    is off a stage() is a Span that is timed but not recorded (false in a
    test of truth, `id` None)."""

    __slots__ = ("name", "id", "parent", "statement", "thread", "t0", "t1", "c0", "c1",
                 "attrs", "_recorded", "_kept", "_cpu", "_t")

    def __init__(self, name: str, statement: Optional[int] = None, keep: bool = True,
                 cpu: bool = False):
        self.name = name
        self.statement = statement
        self.id = self.parent = self.thread = None
        self.t0 = self.t1 = self.c0 = self.c1 = None
        self.attrs: Optional[Dict[str, object]] = None
        self._recorded = _on
        self._kept = _on and keep
        self._cpu = _on and cpu

    def __bool__(self) -> bool:
        return self._recorded

    def __enter__(self) -> "Span":
        if self._recorded:
            if self._kept:
                self._t = _thread()
                self._open(self._t)
            if self._cpu:
                self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._recorded:
            if self._cpu:
                self.c1 = time.thread_time_ns()
            if self._kept:
                t = self._t
                t.stack.pop()
                t.done.append(self._record())
                self._t = None
        return False

    _FIELDS = ("name", "id", "parent", "statement", "thread", "t0", "t1", "c0", "c1")

    def _record(self) -> tuple:
        # the attributes flat (key, value, key, value ...): a tuple nested
        # two deep stays tracked
        attrs = sum(self.attrs.items(), ()) if self.attrs else None
        return (self.name, self.id, self.parent, self.statement, self.thread, self.t0, self.t1,
                self.c0, self.c1, attrs)

    @classmethod
    def _from(cls, record: tuple) -> "Span":
        s = cls.__new__(cls)
        for field, value in zip(cls._FIELDS, record):
            setattr(s, field, value)
        attrs = record[-1]
        s.attrs = dict(zip(attrs[::2], attrs[1::2])) if attrs else None
        s._recorded = s._kept = True
        s._cpu = s.c0 is not None
        s._t = None
        return s

    def _open(self, t: _Thread) -> None:
        self.id = next(_ids)
        self.thread = t.name
        if t.stack:
            top = t.stack[-1]
            self.parent = top.id
            if self.statement is None:
                self.statement = top.statement
        t.stack.append(self)

    def set(self, key: str, value) -> None:
        """An attribute: an integer (`rows`, `bytes`, `position`) or a word
        (`cache`)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value if isinstance(value, str) else int(value)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"statement={self.statement}, {self.t0}-{self.t1} ns, {self.attrs})")


class _Off:
    """What span() gives while the recorder is off: one object for every
    call, doing nothing."""

    __slots__ = ()
    id = statement = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value) -> None:
        pass


_OFF = _Off()


def span(name: str, statement: Optional[int] = None, cpu: bool = False):
    """A span of work that is recorded only while the recorder is on.
    `statement` is the id of the statement it serves; by default that of
    the span open around it. `cpu`: host-only work, whose thread CPU time
    is read too."""
    if not _on:
        return _OFF
    return Span(name, statement, cpu=cpu)


def stage(name: str, keep: bool = True, cpu: bool = True) -> Span:
    """A span of work that is timed whether or not the recorder is on
    (`seconds`); while on it is recorded too, unless `keep` is False, and
    then `statement(..., first=...)` records it later as its first child.
    `cpu` as for span(): the front end's stages are host-only."""
    return Span(name, keep=keep, cpu=cpu)


class _Statement(Span):
    """The span of one SQL statement, whose id its children carry."""

    __slots__ = ("first",)

    def __init__(self, position: int, first: Optional[Span]):
        super().__init__("statement")
        self.set("position", position)
        self.first = first

    def _open(self, t: _Thread) -> None:
        super()._open(t)
        self.statement = self.id

    def __enter__(self) -> "Span":
        super().__enter__()
        first = self.first
        if first and first.id is None:
            self.t0 = first.t0
            first.id, first.thread = next(_ids), self.thread
            first.parent = first.statement = self.id
            _thread().done.append(first._record())
        return self


def statement(position: int, first: Optional[Span] = None):
    """The span of one SQL statement (`position`: its place in its text),
    recorded only while the recorder is on. `first` is a stage timed before
    it with `keep=False` (the parse of its text): the statement then starts
    where that stage did and records it as its first child."""
    if not _on:
        return _OFF
    return _Statement(position, first)


def enable(on: bool = True) -> bool:
    """Turn the recorder on (or off); whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    """Whether the recorder is on."""
    return _on


@contextlib.contextmanager
def recording():
    """The recorder on inside the block, as it was after it."""
    was = enable()
    try:
        yield
    finally:
        enable(was)


def drain() -> List[Span]:
    """Every thread's finished spans, in the order they started; the
    recorder forgets them (and the threads that have ended)."""
    out: List[Span] = []
    with _threads_lock:
        for t in list(_threads):
            done, t.done = t.done, []
            out += map(Span._from, done)
            thread = t.ref()
            if not t.stack and (thread is None or not thread.is_alive()):
                _threads.remove(t)
    out.sort(key=lambda s: s.t0)
    return out

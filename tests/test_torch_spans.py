"""The port's span recorder (hyrise_tpu_torch/utils/spans.py) on the CPU:
off by default and free of clock reads while off, the spans of one
compiled SQL statement and of its result's decode with their statement id,
parents and intervals, StatementMetrics equal to the spans, threads that
never share a parent, the eager operators' synchronize only while
recording, and the benchmark's readers of the spans
(tpch_bench_gpu/program_spans.py, metrics/) on hand-built runs."""

import gc
import threading
import types

import numpy as np
import pytest
import torch

from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans
from tpch_bench_gpu import harness, program_spans

SQL = "SELECT s, COUNT(*) AS n, SUM(b) AS total FROM t WHERE a > 3 GROUP BY s ORDER BY s"
STAGES = {"parse": "parse_s", "translate": "translate_s", "optimize": "optimize_s",
          "plan": "compile_s", "execute": "execute_s"}
NEW_METRICS = ["replay_wait_ms.mean", "replay_launch_ms.mean", "replay_read_ms.mean",
               "decode_copy_ms.mean", "decode_strings_ms.mean", "decode_frame_ms.mean",
               "host_offcpu_ms.mean", "warm_learn_s", "warm_capture_s"]


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.enable(False)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


def _catalog() -> Catalog:
    n = 60
    t = Table.from_arrays(
        "t", [TableColumnDefinition("a", DataType.INT32),
              TableColumnDefinition("b", DataType.FLOAT64),
              TableColumnDefinition("s", DataType.STRING)],
        [np.arange(n, dtype=np.int32), np.linspace(0, 5, n),
         np.array(["x", "y", "z", "w"], dtype=object)[np.arange(n) % 4]], device="cpu")
    cat = Catalog()
    cat.add_table("t", t)
    return cat


def _run(cat, sql=SQL):
    pipeline = SQLPipelineBuilder(sql).with_catalog(cat).with_compiled_execution() \
        .create_pipeline()
    table = pipeline.get_result_table()
    return pipeline.pipeline_statements[-1], table, table.to_pandas()


@pytest.fixture
def graphs(monkeypatch):
    """CompiledQuery's steps on the CPU as on the card: a stand-in graph
    whose capture runs the plan once in capacity mode and whose replay
    hands back those outputs."""
    def capture(self):
        self._graph = types.SimpleNamespace(replay=lambda: None)
        self._graph_outputs = self._execute(learning=False)
        self.captures += 1

    monkeypatch.setattr(compiler.CompiledQuery, "on_cuda", property(lambda self: True))
    monkeypatch.setattr(compiler, "_sync_errors", lambda on: _no_check())
    monkeypatch.setattr(compiler.CompiledQuery, "capture", capture)


class _no_check:
    def __enter__(self):
        return False

    def __exit__(self, *exc):
        return False


def test_off_records_nothing_and_fills_the_metrics():
    assert not spans.enabled()
    st, table, frame = _run(_catalog())
    assert spans.drain() == []
    m = st.metrics
    assert st.last_compiled and len(frame) == 4
    assert min(m.parse_s, m.translate_s, m.optimize_s, m.compile_s, m.execute_s) > 0
    assert m.span_id is None and table.statement is None


def test_off_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(spans.time, "perf_counter_ns", clock)
    monkeypatch.setattr(spans.time, "thread_time_ns", clock)
    first = spans.span("a")
    with first as s, spans.span("b", 7) as t:
        s.set("rows", 3)
    assert first is s is t and not s and s.id is None


def test_kept_spans_leave_the_garbage_collector():
    with spans.recording():
        for i in range(50):
            with spans.span("outer", 1) as s, spans.span("inner"):
                s.set("rows", i)
    # a young collection untracks a record, or one holding attributes on the
    # next (after its attributes' tuple): before either reaches the old
    # generation, whose growth sets off full collections
    gc.collect(0)
    gc.collect(1)
    assert not any(gc.is_tracked(r) for r in spans._thread().done)
    recorded = spans.drain()
    assert [s.name for s in recorded[:2]] == ["outer", "inner"]
    assert recorded[1].parent == recorded[0].id and recorded[1].statement == 1
    assert recorded[0].attrs == {"rows": 0} and recorded[-2].attrs == {"rows": 49}


def _by_id(recorded):
    return {s.id: s for s in recorded}


def test_one_compiled_statement_gives_its_spans(graphs):
    cat = _catalog()
    with spans.recording():
        first, _, _ = _run(cat)
        st, table, frame = _run(cat)  # the cached CompiledQuery replays
    recorded = spans.drain()
    assert not spans.enabled()
    ids = {s.id for s in recorded}
    assert len(ids) == len(recorded)
    for statement in (first, st):
        sid = statement.metrics.span_id
        mine = [s for s in recorded if s.statement == sid]
        names = [s.name for s in mine]
        root = [s for s in mine if s.name == "statement"]
        assert len(root) == 1 and root[0].id == sid and root[0].attrs == {"position": 0}
        by_id = _by_id(mine)
        for s in mine:
            assert s.t0 <= s.t1 and s.thread == "MainThread"
            host = s.name in program_spans.HOST_ONLY  # the thread's CPU time is read there
            assert (s.c0 is not None) is host and (s.c1 is not None) is host
            assert not host or s.c0 <= s.c1
            if s.parent is not None:  # each child inside its parent
                p = by_id[s.parent]
                assert p.t0 <= s.t0 and s.t1 <= p.t1
        for name, field in STAGES.items():
            if name in names:
                (stage,) = [s for s in mine if s.name == name]
                assert stage.parent == sid
                assert getattr(statement.metrics, field) == stage.seconds
        for name in ("decode", "decode.copy", "decode.strings", "decode.frame",
                     "compiled.wait", "compiled.replay", "compiled.read", "compiled.columns"):
            assert name in names, name
        decode = [s for s in mine if s.name == "decode"]
        assert len(decode) == 1 and decode[0].parent is None
        assert all(by_id[s.parent].name == "decode" for s in mine if s.name.startswith("decode."))
        assert all(by_id[s.parent].name == "execute" for s in mine
                   if s.name.startswith("compiled."))
    first_names = {s.name for s in recorded if s.statement == first.metrics.span_id}
    assert {"translate", "optimize", "plan", "compiled.learn", "compiled.capture"} <= first_names
    (learn,) = [s for s in recorded if s.name == "compiled.learn"]
    assert any(s.parent == learn.id for s in recorded)  # the learning run's operators
    assert table.statement == st.metrics.span_id and len(frame) == 4
    copies = [s for s in recorded if s.name == "decode.copy" and s.statement == table.statement]
    assert sum(s.attrs["bytes"] for s in copies if s.attrs) > 0
    strings = [s for s in recorded if s.name == "decode.strings" and s.statement == table.statement]
    assert [s.attrs["rows"] for s in strings] == [4]


def test_threads_never_share_a_parent(graphs):
    cat = _catalog()
    _run(cat)
    barrier = threading.Barrier(2)
    errors = []

    def client():
        try:
            barrier.wait(timeout=30)
            for _ in range(3):
                _run(cat)
        except Exception as e:  # reported below
            errors.append(e)

    with spans.recording():
        threads = [threading.Thread(target=client, name=f"c{i}") for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    recorded = spans.drain()
    by_id = _by_id(recorded)
    parents = {}
    for s in recorded:
        assert s.thread in ("c0", "c1")
        if s.parent is not None:
            assert by_id[s.parent].thread == s.thread
            parents.setdefault(s.parent, set()).add(s.thread)
    assert all(len(t) == 1 for t in parents.values())
    assert len({s.statement for s in recorded if s.name == "statement"}) == 6


class _Stub(AbstractOperator):
    """An operator whose output says it is on the card."""

    name = "Stub"

    def _on_execute(self, context):
        return types.SimpleNamespace(device=torch.device("cuda"), num_rows=1)


def test_eager_operators_synchronize_only_while_recording(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    _Stub().execute()
    execute_plan(TPCH_PLANS[6](_tpch()))
    assert calls == []
    with spans.recording():
        op = _Stub()
        op.execute()
    assert calls == [torch.device("cuda")]
    (s,) = [s for s in spans.drain() if s.name == "Stub"]
    assert s.seconds <= op.performance_data.walltime_s


def _tpch():
    from hyrise_tpu_torch.tpch import dbgen

    cat = Catalog()
    for name, t in dbgen.generate_tables(0.001, device="cpu").items():
        cat.add_table(name, t)
    return cat


# -- the benchmark's readers ------------------------------------------------------


def _span(name, statement, t0, t1, cpu=None, thread="client1", parent=None):
    s = spans.Span(name, statement)
    s.t0, s.t1 = t0, t1
    s.c0, s.c1 = 0, (t1 - t0) if cpu is None else cpu
    s.thread, s.parent = thread, parent
    return s


def _hand_built_run():
    """Set-up (statement 1: learn 2 s, capture 3 s, before the window at
    10 s), then two requests of client 0 (statements 2 and 3) and one that
    failed."""
    ms = 1_000_000
    requests = []
    for sid, qid, t in ((2, 10, 10.0), (3, 6, 10.1), (None, 1, 10.2)):
        r = harness.Request(0, qid, t, t + 0.05, t + 0.09)
        r.statement = sid
        requests.append(r)
    requests[2].error = "failed"
    s = 10**9
    recorded = [
        _span("compiled.learn", 1, 1 * s, 3 * s), _span("compiled.capture", 1, 4 * s, 7 * s),
        _span("statement", 2, 10 * s, 10 * s + 50 * ms),
        _span("parse", 2, 10 * s, 10 * s + 1 * ms, cpu=ms // 2),
        _span("compiled.wait", 2, 10 * s + 2 * ms, 10 * s + 6 * ms),
        _span("compiled.replay", 2, 10 * s + 6 * ms, 10 * s + 7 * ms, cpu=ms // 4),
        _span("compiled.read", 2, 10 * s + 7 * ms, 10 * s + 47 * ms, cpu=0),
        _span("decode", 2, 10 * s + 50 * ms, 10 * s + 90 * ms),
        _span("decode.copy", 2, 10 * s + 50 * ms, 10 * s + 52 * ms),
        _span("decode.copy", 2, 10 * s + 53 * ms, 10 * s + 55 * ms),
        _span("decode.strings", 2, 10 * s + 55 * ms, 10 * s + 85 * ms, cpu=20 * ms),
        _span("decode.frame", 2, 10 * s + 85 * ms, 10 * s + 90 * ms),
        _span("compiled.replay", 3, 10 * s + 102 * ms, 10 * s + 103 * ms),
        _span("compiled.read", 3, 10 * s + 103 * ms, 10 * s + 109 * ms),
    ]
    run = harness.Run({}, {}, requests, {"setup_s": 12.0}, 1.0, {}, None)
    run.spans = recorded
    return run


@pytest.mark.parametrize("name, expected", [
    ("replay_wait_ms.mean", 4 / 2), ("replay_launch_ms.mean", (1 + 1) / 2),
    ("replay_read_ms.mean", (40 + 6) / 2), ("decode_copy_ms.mean", 4 / 2),
    ("decode_strings_ms.mean", 30 / 2), ("decode_frame_ms.mean", 5 / 2),
    # parse 0.5 ms off the CPU, replay 0.75, strings 10; request 3 none
    ("host_offcpu_ms.mean", (0.5 + 0.75 + 10) / 2),
    ("warm_learn_s", 2.0), ("warm_capture_s", 3.0)])
def test_span_readers_on_a_hand_built_run(name, expected):
    reader = harness.metric_reader(name)
    assert reader.read(_hand_built_run()) == pytest.approx(expected)
    bare = _hand_built_run()
    del bare.spans
    assert reader.read(bare) is None
    bare.spans = []
    assert reader.read(bare) is None


def test_span_readers_are_the_nine():
    assert sorted(NEW_METRICS) == sorted(
        p.stem for p in (harness.ROOT / "metrics").glob("*.py")
        if "program_spans" in p.read_text())


def test_idle_gaps_name_the_innermost_program_span():
    run = _hand_built_run()
    off = 5
    request_spans = harness._spans(run.requests, 2, off)
    named = program_spans.client_spans(run.requests, run.spans, request_spans, off)
    ms = 1_000_000
    at = [(10 * 10**9 + k * ms + off) for k in (30, 60, 89, 101, 49)]
    labels = [harness.trace_mod.span_at(named[0], [a for a, _, _ in named[0]], t) for t in at]
    assert labels == ["compiled.read q10", "decode.strings q10", "decode.frame q10",
                      "frontend q06", "statement q10"]
    assert named[1] == []
    # without the program's spans, the request spans as they were
    assert program_spans.client_spans(run.requests, [], request_spans, off) == \
        [sorted(s) for s in request_spans]
    pieces = named[0]
    assert all(a < b for a, b, _ in pieces)
    assert all(p[1] <= q[0] for p, q in zip(pieces, pieces[1:]))


def test_innermost_cuts_nested_intervals():
    cut = program_spans.innermost([(0, 10, "s"), (0, 2, "p"), (3, 9, "e"), (4, 5, "r"),
                                   (12, 14, "d")])
    assert cut == [(0, 2, "p"), (2, 3, "s"), (3, 4, "e"), (4, 5, "r"), (5, 9, "e"),
                   (9, 10, "s"), (12, 14, "d")]

"""Compiled execution's process-wide counters (`compiled_counts()` in
hyrise_tpu_torch/plan/compiler.py) and what reads them: the learning runs,
the capacity oracle's overflow retries, the captures and the bytes the
captured graphs' pools hold; the `retry` and `bytes` attributes of the
`compiled.learn` and `compiled.capture` spans; the benchmark's readers
`setup_retries` and `graph_pool_gb`; and the benchmark's SF10 power cell,
run through its own configuration, traffic and limits on CPU tensors."""

import gc
import json
import sys
import threading

import numpy as np
import pytest

from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans
from tpch_bench_gpu import calibrate, datagen, harness

SQL = "SELECT a, b FROM t WHERE a > 5 ORDER BY a"
CELL = "tpch-sf10-compiled.power"
STREAM_00 = [14, 2, 9, 20, 6, 17, 18, 8, 21, 13, 3, 22, 16, 4, 11, 15, 1, 10, 19, 5, 7, 12]


def _catalog() -> Catalog:
    n = 60
    t = Table.from_arrays(
        "t", [TableColumnDefinition("a", DataType.INT32),
              TableColumnDefinition("b", DataType.FLOAT64)],
        [np.arange(n, dtype=np.int32), np.linspace(0, 5, n)], device="cpu")
    cat = Catalog()
    cat.add_table("t", t)
    return cat


def _run(cat):
    pipeline = SQLPipelineBuilder(SQL).with_catalog(cat).with_compiled_execution() \
        .create_pipeline()
    frame = pipeline.get_result_table().to_pandas()
    st = pipeline.pipeline_statements[-1]
    assert st.last_compiled and frame["a"].tolist() == list(range(6, 60))
    return st.last_compiled_query


def _forced(cq):
    """Every site's capacity below its count: the next run overflows once."""
    cq.caps[:] = [1] * len(cq.caps)


def _delta(before, after):
    return {k: after[k] - before[k] for k in ("learning_runs", "retries", "captures")}


def test_an_overflow_adds_one_retry_and_one_learning_run():
    cat = _catalog()
    cq = _run(cat)
    before = compiler.compiled_counts()
    assert _run(cat) is cq and cq.last_retries == 0
    plain = _delta(before, compiler.compiled_counts())
    # on CPU tensors every run is an uncaptured learning run
    assert plain == {"learning_runs": 1, "retries": 0, "captures": 0}
    _forced(cq)
    before = compiler.compiled_counts()
    assert _run(cat) is cq and cq.last_retries == 1
    assert _delta(before, compiler.compiled_counts()) == \
        {"learning_runs": 2, "retries": 1, "captures": 0}


@pytest.mark.parametrize("n_threads", [2, 12])
def test_counts_from_threads_add_up(n_threads):
    """Each thread forces overflows in its own compiled statement; no
    count is lost, with a shortened switch interval."""
    runs = 6
    cats = [_catalog() for _ in range(n_threads)]
    cqs = [_run(c) for c in cats]
    barrier = threading.Barrier(n_threads)
    errors = []

    def client(i):
        try:
            barrier.wait()
            for _ in range(runs):
                _forced(cqs[i])
                assert _run(cats[i]) is cqs[i] and cqs[i].last_retries == 1
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = compiler.compiled_counts()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        after = compiler.compiled_counts()
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert _delta(before, after) == {"learning_runs": 2 * n_threads * runs,
                                     "retries": n_threads * runs, "captures": 0}


class _Graph:
    """Stands in for a captured graph: what the pool's bytes are held by."""


def test_a_pool_is_held_while_its_graph_lives(monkeypatch):
    monkeypatch.setattr(compiler, "_counts", dict.fromkeys(compiler._counts, 0))
    a, b = _Graph(), _Graph()
    compiler._hold_pool(a, 3_000)
    compiler._hold_pool(b, 5_000)
    assert compiler.compiled_counts() == {"learning_runs": 0, "retries": 0, "captures": 2,
                                          "pool_bytes_live": 8_000, "pool_bytes_peak": 8_000}
    del a
    gc.collect()
    c = _Graph()
    compiler._hold_pool(c, 1_000)
    counts = compiler.compiled_counts()
    assert counts["pool_bytes_live"] == 6_000 and counts["pool_bytes_peak"] == 8_000
    del b, c
    gc.collect()
    counts = compiler.compiled_counts()
    assert counts["pool_bytes_live"] == 0 and counts["captures"] == 3


def test_a_dropped_graph_gives_its_pool_back(monkeypatch):
    """CompiledQuery's own steps with a stand-in graph on CPU tensors: the
    capture's pool is counted, the `compiled.capture` span carries it, and
    dropping the graph (an overflow in a replay) gives it back."""
    monkeypatch.setattr(compiler, "_counts", dict.fromkeys(compiler._counts, 0))

    def capture(self):
        graph = _Graph()
        graph.replay = lambda: None
        self._graph, self._graph_outputs = graph, self._execute(learning=False)
        self.pool_mb = 7_000 / 2**20
        self.captures += 1
        compiler._hold_pool(graph, 7_000)

    monkeypatch.setattr(compiler.CompiledQuery, "on_cuda", property(lambda self: True))
    monkeypatch.setattr(compiler, "_sync_errors", lambda on: _NoCheck())
    monkeypatch.setattr(compiler.CompiledQuery, "capture", capture)
    cat = _catalog()
    with spans.recording():
        cq = _run(cat)
        assert _run(cat) is cq  # a replay
    recorded = spans.drain()
    assert [s.attrs for s in recorded if s.name == "compiled.capture"] == [{"bytes": 7_000}]
    assert [s.attrs for s in recorded if s.name == "compiled.learn"] == [{"retry": 0}]
    assert compiler.compiled_counts()["pool_bytes_live"] == 7_000
    cq.drop_graph()
    gc.collect()
    counts = compiler.compiled_counts()
    assert counts["pool_bytes_live"] == 0 and counts["pool_bytes_peak"] == 7_000
    assert counts["captures"] == 1 and counts["retries"] == 0


class _NoCheck:
    def __enter__(self):
        return False

    def __exit__(self, *exc):
        return False


def test_learn_spans_count_the_retries():
    cat = _catalog()
    cq = _run(cat)
    _forced(cq)
    with spans.recording():
        _run(cat)
    learns = [s for s in spans.drain() if s.name == "compiled.learn"]
    assert [s.attrs for s in learns] == [{"retry": 0}, {"retry": 1}]


# -- the benchmark's readers ----------------------------------------------------


def _bench_run(retries):
    requests = [harness.Request(0, q, 0.0, compiled=True, retries=r)
                for q, r in zip(STREAM_00, retries)]
    return harness.Run({}, {}, requests, {"setup_s": 1.0}, 1.0, {}, None)


COUNTS = {"learning_runs": 30, "retries": 6, "captures": 25, "pool_bytes_live": 0,
          "pool_bytes_peak": 52_400_000_000}


@pytest.mark.parametrize("name, want", [("setup_retries", 4), ("graph_pool_gb", 52.4)])
def test_readers_read_the_counters(monkeypatch, name, want):
    monkeypatch.setattr(compiler, "_counts", dict(COUNTS))
    run = _bench_run([0, 2, 0])  # two of the six retries fell in the window
    assert harness.metric_reader(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", ["setup_retries", "graph_pool_gb"])
def test_readers_read_nothing_without_the_counters(monkeypatch, name):
    reader = harness.metric_reader(name)
    run = _bench_run([0, 0])
    # nothing captured: CPU tensors
    monkeypatch.setattr(compiler, "_counts", dict(COUNTS, captures=0))
    assert reader.read(run) is None
    # a program without compiled_counts (an older tree)
    monkeypatch.delattr(compiler, "compiled_counts")
    assert reader.read(run) is None


# -- the SF10 power cell --------------------------------------------------------


def test_the_power_cell_files():
    spec = harness.bench_spec()
    wl, config, traffic = harness.cell(spec, CELL)
    assert wl["chips"] == 1 and wl["config"] == "tpch-sf10-compiled"
    assert config["scale_factor"] == 10 and config["execution"]["compiled"] is True
    assert config["execution"]["mvcc"] is False and config["reduced"] == []
    assert traffic["loop"] == "closed" and traffic["streams"] == [STREAM_00]
    entry = {c["name"]: c for c in spec["configs"]}["tpch-sf10-compiled"]
    assert entry["reduced"] == [] and entry["source"] == config["source"]
    limits = harness.limits_of(config)
    assert limits["exact_mismatches"] == 0 and 0 < limits["float_rel_err_max"] < 1e-6
    traced = {m["name"] for m in harness.metrics_of(spec, CELL, True)}
    assert traced == {"setup_retries", "graph_pool_gb"}
    assert {m["name"] for m in harness.metrics_of(spec, CELL, False)} == \
        {"latency_geomean_ms", "setup_s"}


def test_the_power_cell_runs_correct_on_cpu_tensors(tmp_path):
    logged = []
    dump = tmp_path / "requests.json"
    out = harness.run_cell(CELL, 2**40 + 23, 3.0, False, device="cpu", scale_factor=0.01,
                           log=lambda *a: logged.append(" ".join(map(str, a))),
                           dump=str(dump))
    assert out["correct"] is True, logged[-8:]
    assert out["failed"] == 0
    assert "warm-up: 22 of 22 texts run compiled" in logged
    assert out["checks"]["answers_compared"]["value"] == 22
    requests = json.loads(dump.read_text())["requests"]
    assert len(requests) == out["attempted"] >= 22
    assert all(r["compiled"] and r["client"] == 0 for r in requests)
    assert [r["qid"] for r in requests[:22]] == STREAM_00
    assert set(out["metrics"]) == {"latency_geomean_ms", "setup_s"}


@pytest.mark.parametrize("seed", [7, 2**33 + 5])
def test_the_float32_control_fails_the_power_cells_limit(seed):
    limits = harness.limits_of(harness.cell(harness.bench_spec(), CELL)[1])
    got = calibrate.control(datagen.generate_specs(0.05, seed), range(1, 23), "cpu")
    assert got["float_rel_err_max"] > limits["float_rel_err_max"]

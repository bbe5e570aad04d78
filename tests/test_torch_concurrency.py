"""Repairs for the port's first concurrent callers (server sessions, the
operator scheduler), each under threads:

- kernels/build.py builds and loads a source once per process, however many
  threads ask for it at once (nvcc stubbed here: there is none on the CPU);
- a Delete takes its rows with one check-and-set under the table's write
  lock: of two transactions deleting the same rows at the same moment,
  exactly one commits and the other raises TransactionConflict, every time
  (ROADMAP C20; the JAX package's Delete has the gap);
- commits and rollbacks write the MVCC vectors under that lock too, so that
  another session's growth of the vectors cannot swallow them;
- the wrappers' launch counters lose no count when threads launch at once.
"""

import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hyrise_tpu_torch.concurrency.transaction import (INVALID_TID, MAX_COMMIT_ID, MvccData,
                                                     TransactionConflict)
from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition as Def
from hyrise_tpu_torch.types import DataType

THREADS = 8
KERNELS = pathlib.Path(build.__file__).resolve().parent


class fast_switching:
    """Threads switch every 10 microseconds inside the block."""

    def __enter__(self):
        self.interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)

    def __exit__(self, *exc):
        sys.setswitchinterval(self.interval)


def run_threads(n, target):
    """Start n threads of target(i) behind a barrier; return their
    exceptions."""
    barrier = threading.Barrier(n, timeout=60)
    errors = []

    def run(i):
        try:
            barrier.wait()
            target(i)
        except BaseException as e:  # collected for the test to look at
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    with fast_switching():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return errors


# -- (a) one build a source ------------------------------------------------------


@pytest.fixture()
def stub_nvcc(tmp_path, monkeypatch):
    """build.py with a fake nvcc (it writes its -o file after a pause) and a
    fake CDLL; returns the list of compile commands."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        threading.Event().wait(0.05)  # a slow compile: others must wait, not start
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library " + str(threading.get_ident()).encode())
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    return calls


def test_threads_loading_one_source_compile_once(stub_nvcc):
    libs = []
    errors = run_threads(THREADS, lambda i: libs.append(build.load("q6_scan")))
    assert not errors, errors
    assert len(stub_nvcc) == 1
    assert len(libs) == THREADS and all(lib is libs[0] for lib in libs)
    lib_path = pathlib.Path(libs[0][1])
    assert lib_path.exists() and not list(lib_path.parent.glob("*.partial"))
    assert build.build_log("q6_scan").startswith("nvcc seconds: ")


def test_threads_loading_several_sources_compile_each_once(stub_nvcc):
    sources = ("q6_scan", "compact", "join_probe", "hash_lookup")
    errors = run_threads(THREADS, lambda i: build.load(sources[i % len(sources)]))
    assert not errors, errors
    built = sorted(pathlib.Path(cmd[-1]).stem for cmd in stub_nvcc)
    assert built == sorted(sources)
    build.build_all()  # every library is there: nothing is compiled again
    assert len(stub_nvcc) == len(build.SOURCES)


def test_partial_files_are_named_per_thread(stub_nvcc):
    build.load("compact")
    partial = pathlib.Path(stub_nvcc[0][stub_nvcc[0].index("-o") + 1]).name
    assert partial.endswith(f".{threading.get_ident()}.partial")


# -- (b) racing DELETEs: ROADMAP C20 ---------------------------------------------


def mvcc_table(n=64):
    cat = Catalog(device="cpu")
    t = Table.from_arrays("t", [Def("a", DataType.INT32)],
                          [np.arange(n, dtype=np.int32)], device="cpu")
    t.mvcc = MvccData.for_new_table(n, t.capacity, device="cpu")
    cat.add_table("t", t)
    return cat


@pytest.mark.parametrize("statement", ["DELETE FROM t WHERE a < 40",
                                       "UPDATE t SET a = a + 100 WHERE a >= 20"])
def test_racing_writes_of_the_same_rows_commit_once(statement):
    for _ in range(40):
        cat = mvcc_table()
        tm = cat.transaction_manager
        contexts = [tm.new_transaction_context() for _ in range(2)]
        outcome = [None, None]

        def write(i):
            try:
                SQLPipelineBuilder(statement).with_catalog(cat).with_mvcc(True) \
                    .with_transaction_context(contexts[i]).dont_cache_query_plans() \
                    .create_pipeline().get_result_table()
                outcome[i] = "done"
            except TransactionConflict:
                contexts[i].rollback()
                outcome[i] = "conflict"

        errors = run_threads(2, write)
        assert not errors, errors
        assert sorted(outcome) == ["conflict", "done"], outcome
        winner = contexts[outcome.index("done")]
        winner.commit()
        rows = SQLPipelineBuilder("SELECT COUNT(*) FROM t").with_catalog(cat) \
            .with_mvcc(True).create_pipeline().get_result_table().rows()
        assert rows == [(24 if statement.startswith("DELETE") else 64,)]


def test_racing_inserts_all_land():
    cat = mvcc_table(0)

    def insert(i):
        for k in range(10):
            SQLPipelineBuilder(f"INSERT INTO t VALUES ({100 * i + k})").with_catalog(cat) \
                .dont_cache_query_plans().create_pipeline().get_result_table()

    errors = run_threads(THREADS, insert)
    assert not errors, errors
    rows = SQLPipelineBuilder("SELECT a FROM t").with_catalog(cat).with_mvcc(True) \
        .create_pipeline().get_result_table().rows()
    assert sorted(int(r[0]) for r in rows) == sorted(
        100 * i + k for i in range(THREADS) for k in range(10))



def sql(cat, text, context=None):
    builder = SQLPipelineBuilder(text).with_catalog(cat).with_mvcc(True) \
        .dont_cache_query_plans()
    if context is not None:
        builder = builder.with_transaction_context(context)
    return builder.create_pipeline().get_result_table()


@pytest.mark.parametrize("end", ["commit", "rollback"])
def test_commit_and_rollback_during_another_sessions_growth_are_kept(monkeypatch, end):
    """Session A ends (commit or rollback) its INSERT and DELETE while session
    B's INSERT grows the MVCC vectors. The grow below is MvccData.grow with a
    pause between copying the old vectors and binding the copies: an end
    that did not wait for the table's write lock would store into the old
    vectors in that pause, and be lost."""
    cat = mvcc_table(1000)
    tm = cat.transaction_manager
    a = tm.new_transaction_context()
    sql(cat, "INSERT INTO t VALUES (5000)", a)  # grows 1,000 -> 1,500 rows
    sql(cat, "DELETE FROM t WHERE a = 0", a)
    copied, ending = threading.Event(), threading.Event()

    def paused_grow(self, new_capacity):
        extra = new_capacity - self.capacity
        copies = [torch.cat([v, torch.full((extra,), fill, dtype=torch.int64)])
                  for v, fill in ((self.tids, INVALID_TID),
                                  (self.begin_cids, MAX_COMMIT_ID),
                                  (self.end_cids, MAX_COMMIT_ID))]
        copied.set()
        assert ending.wait(60)
        time.sleep(0.2)  # A's end runs now, unless it waits for the lock
        self.tids, self.begin_cids, self.end_cids = copies
        return self

    monkeypatch.setattr(MvccData, "grow", paused_grow)
    b = tm.new_transaction_context()

    def insert_b():
        sql(cat, "INSERT INTO t SELECT a FROM t", b)  # 1,001 + 1,000 > 1,500

    grower = threading.Thread(target=insert_b)
    grower.start()
    assert copied.wait(60)
    ending.set()
    getattr(a, end)()
    grower.join(60)
    assert not grower.is_alive()
    assert cat.get_table("t").capacity > 1500  # B's insert grew the table
    b.commit()

    rows = sorted(int(r[0]) for r in sql(cat, "SELECT a FROM t").rows())
    if end == "commit":
        assert rows == sorted(list(range(1, 1000)) + [5000] + list(range(1000)))
    else:
        assert rows == sorted(list(range(1000)) * 2)
    mvcc = cat.get_table("t").mvcc
    assert int(mvcc.tids[1000]) == INVALID_TID  # A's inserted row is not locked
    if end == "rollback":
        # nor is its deleted row: another session can take it (with B's copy)
        c = tm.new_transaction_context()
        sql(cat, "DELETE FROM t WHERE a = 0", c)
        c.commit()
        assert sorted(int(r[0]) for r in sql(cat, "SELECT a FROM t").rows()) == \
            sorted(list(range(1, 1000)) * 2)


# -- (c) launch counters ----------------------------------------------------------


def test_launch_counts_lose_nothing_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.rows_seen = 0
    per_thread = 20_000
    errors = run_threads(THREADS, lambda i: [build.count_launch(wrapper, rows_seen=3)
                                             for _ in range(per_thread)])
    assert not errors, errors
    assert wrapper.launches == THREADS * per_thread
    assert wrapper.rows_seen == 3 * THREADS * per_thread


def test_every_wrapper_counts_through_the_lock():
    for path in KERNELS.glob("*.py"):
        if path.name == "build.py":
            continue
        source = path.read_text()
        assert not re.search(r"\.(launches|rows_seen|pairs_out)\s*\+=", source), path.name


def test_one_transaction_manager_per_catalog_under_threads():
    cat = Catalog(device="cpu")
    managers = []
    errors = run_threads(THREADS, lambda i: managers.append(cat.transaction_manager))
    assert not errors
    assert all(m is managers[0] for m in managers)

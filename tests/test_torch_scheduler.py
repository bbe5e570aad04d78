"""The port's operator-task scheduler (hyrise_tpu_torch/parallel/scheduler.py)
against the JAX package's (hyrise_tpu/parallel/scheduler.py): the TPC-H hand
plans at SF 0.01 through PoolScheduler equal to ImmediateScheduler, and both
equal to the JAX plans run through the JAX scheduler; shared subplans, error
propagation, drained intermediates and the JobTask route of tasks.py (the
cases of tests/test_periphery.py and tests/test_parallel.py)."""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.parallel import scheduler as jax_scheduler
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.utils.table_eq import assert_tables_equal
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.ops.join import Product
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.parallel.scheduler import (ImmediateScheduler, JobTask,
                                                 OperatorTask, PoolScheduler,
                                                 current_scheduler, schedule_plan,
                                                 set_scheduler)
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.encoding import ChunkEncoder, EncodingType
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition as Def
from hyrise_tpu_torch.tasks import ChunkCompressionTask
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)

SF = 0.01
QUERY_SF = {20: 0.05}
_state = {}


def catalogs(sf):
    if sf not in _state:
        jcat, cat = JaxCatalog(), Catalog(device="cpu")
        for name, t in jax_generate_tables(sf).items():
            jcat.add_table(name, t)
        for name, t in generate_tables(sf, device="cpu").items():
            cat.add_table(name, t)
        _state[sf] = (jcat, cat)
    return _state[sf]


@pytest.fixture(autouse=True)
def no_scheduler_left():
    yield
    set_scheduler(None)
    jax_scheduler.set_scheduler(None)


def small_table():
    return Table.from_arrays(
        "t", [Def("a", DataType.INT32), Def("s", DataType.STRING, True)],
        [np.array([1, 2, 3], dtype=np.int32), np.array(["x", None, "z"], dtype=object)],
        device="cpu")


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_pool_equals_immediate_and_jax(qid):
    jcat, cat = catalogs(QUERY_SF.get(qid, SF))
    set_scheduler(None)
    alone = schedule_plan(TPCH_PLANS[qid](cat)).rows()
    set_scheduler(PoolScheduler(workers=4))
    pooled = schedule_plan(TPCH_PLANS[qid](cat)).rows()
    jax_scheduler.set_scheduler(jax_scheduler.PoolScheduler(workers=4))
    want = jax_scheduler.schedule_plan(JAX_PLANS[qid](jcat)).rows()
    assert pooled == alone  # the same operators on the same inputs: equal bits
    assert_tables_equal(pooled, want, ordered=True, rel_tol=1e-6, abs_tol=0.0)


def test_tasks_of_shared_subplans():
    base = TableWrapper(small_table())
    s1 = TableScan(base, ast.col("a") > ast.lit(1))
    s2 = TableScan(base, ast.col("a") > ast.lit(2))
    tasks = OperatorTask.make_tasks_from_operator(Product(s1, s2))
    assert len(tasks) == 4  # the shared base is one task
    assert [len(t.successors) for t in tasks] == [2, 1, 1, 0]
    set_scheduler(PoolScheduler(workers=4))
    out = schedule_plan(Product(s1, s2))
    assert out.num_rows == 2


@pytest.mark.parametrize("pool", [False, True], ids=["immediate", "pool"])
def test_errors_propagate_as_in_jax(pool):
    """A failing operator's exception reaches the caller of schedule_plan,
    in both packages (tests/test_periphery.py's case)."""
    from hyrise_tpu.expression import ast as jax_ast
    from hyrise_tpu.ops import TableWrapper as JaxTableWrapper
    from hyrise_tpu.ops.table_scan import TableScan as JaxTableScan
    from hyrise_tpu.storage.table import Table as JaxTable
    set_scheduler(PoolScheduler(workers=2) if pool else ImmediateScheduler())
    jax_scheduler.set_scheduler(
        jax_scheduler.PoolScheduler(workers=2) if pool else None)
    with pytest.raises(KeyError):
        schedule_plan(TableScan(TableWrapper(small_table()),
                                ast.col("nope") > ast.lit(1)))
    jt = JaxTable.from_pandas("t", pd.DataFrame({"a": np.array([1, 2, 3], dtype=np.int32)}))
    with pytest.raises(KeyError):
        jax_scheduler.schedule_plan(JaxTableScan(JaxTableWrapper(jt),
                                                 jax_ast.col("nope") > jax_ast.lit(1)))


def test_an_error_stops_the_plan():
    """A failing branch: its sibling may finish, nothing above them runs."""
    t = TableWrapper(small_table())
    good = TableScan(t, ast.col("a") > ast.lit(1))
    bad = TableScan(t, ast.col("nope") > ast.lit(1))
    top = Product(good, bad)
    set_scheduler(PoolScheduler(workers=2))
    with pytest.raises(KeyError):
        schedule_plan(top)
    assert top.get_output() is None


def test_schedule_plan_drains_intermediates():
    """tests/test_parallel.py's case: a drained predecessor's output is
    dropped once its last consumer ran; only the root keeps its result."""
    t = Table.from_arrays("t", [Def("a", DataType.INT64)],
                          [np.arange(4096, dtype=np.int64)], device="cpu")
    for scheduler in (None, PoolScheduler(workers=4)):
        set_scheduler(scheduler)
        chain = TableWrapper(t)
        mids = []
        for i in range(5):
            chain = Projection(TableScan(chain, ast.col("a") >= ast.lit(i)),
                               [("a", ast.col("a") + ast.lit(1))])
            mids.extend([chain.inputs[0], chain])
        out = schedule_plan(chain)
        assert out is not None and out.num_rows == 4096
        for op in mids[:-1]:
            assert op.get_output() is None, op.name
        assert chain.get_output() is out
        out2 = schedule_plan(chain, drain=False)
        assert out2.num_rows == out.num_rows
        assert mids[0].get_output() is not None  # drain=False keeps them


def test_pool_overlaps_independent_branches():
    """Two branches run on two workers at once: each waits for the other."""
    barrier = threading.Barrier(2, timeout=30)

    class Meet(TableWrapper):
        def _on_execute(self, context):
            barrier.wait()
            return super()._on_execute(context)

    t = small_table()
    set_scheduler(PoolScheduler(workers=2))
    out = schedule_plan(Product(Meet(t), Meet(t)))
    assert out.num_rows == 9


def test_job_task_runs_inline_or_on_the_pool():
    set_scheduler(None)
    assert JobTask(lambda: threading.get_ident()).schedule().join() == threading.get_ident()
    pool = PoolScheduler(workers=2)
    set_scheduler(pool)
    assert current_scheduler() is pool
    assert JobTask(lambda: threading.get_ident()).schedule().join() != threading.get_ident()
    with pytest.raises(ZeroDivisionError):
        JobTask(lambda: 1 // 0).schedule().join()
    with pytest.raises(RuntimeError):
        JobTask(lambda: 1).join()


def test_chunk_compression_task_through_the_scheduler():
    """tasks.py's JobTask route: the task re-encodes through the pool as it
    does when run on the caller."""
    table = Table.from_arrays("t", [Def("a", DataType.INT32)],
                              [np.repeat(np.arange(8, dtype=np.int32), 4)], device="cpu")
    results = []
    for scheduler in (None, PoolScheduler(workers=2)):
        set_scheduler(scheduler)
        cat = Catalog(device="cpu")
        encoded = ChunkEncoder.encode_table(table, EncodingType.RUN_LENGTH)
        dense = Table([c for c in table.columns], table.num_rows, name="t")
        dense.encoding_spec = encoded.encoding_spec
        cat.add_table("t", dense)
        out = JobTask(ChunkCompressionTask("t", cat).run).schedule().join()
        assert cat.get_table("t") is out
        assert out.columns[0].encoded is not None
        results.append(out.rows())
    assert results[0] == results[1] == table.rows()

"""IndexScan and JoinIndex over shards (hyrise_tpu_torch/parallel/
dist_compiler.py and parallel/blocked_dist.py) on 4 in-process CPU shards,
against the JAX DistributedCompiledQuery over `make_mesh(4)` on the forced
CPU devices.

A shard has no index, and neither has any table of the JAX package's
traced program, a replicated one included. So over shards an IndexScan
gathers its input and scans it (rows in the gathered order,
`index_fallback` set), and a JoinIndex is a join like any other, placed by
the join rules and sorting its build side (`index_used` never True), in
both the port's DistributedQuery and DistributedCompiledQuery:

- IndexScan over a sharded and over a replicated source that carries the
  index, simple and composite, under a grouped aggregate: rows in order,
  join decisions and exchange_stats() equal to the JAX package's;
- JoinIndex in every mode (and a non-equi condition) with a replicated
  build side that carries the index (broadcast), co-partitioned, and
  shuffled: the same, with SEMI and ANTI under a global aggregate held to
  single node (ROADMAP C4);
- the SQL route: statements over indexed tables run distributed through
  both builder flags, with the JAX pipeline's rows;
- BlockedDistributedQuery, eager and compiled: an IndexScan on the stream
  path is refused, as by the JAX BlockedDistributedQuery; a JoinIndex and an
  IndexScan of a resident table give its answer."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.get_table import GetTable as JGetTable
from hyrise_tpu.ops.index_scan import IndexScan as JIndexScan
from hyrise_tpu.ops.join import JoinIndex as JJoinIndex
from hyrise_tpu.ops.sort import Sort as JSort
from hyrise_tpu.parallel.blocked_dist import BlockedDistributedQuery as JBlockedDistributedQuery
from hyrise_tpu.parallel.dist_compiler import (DistributedCompiledQuery as JDistributedCompiledQuery,
                                               ShardedCatalog as JShardedCatalog)
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.plan.compiler import PlanNotCompilable as JPlanNotCompilable
from hyrise_tpu.sql.pipeline import SQLPipelineBuilder as JSQLPipelineBuilder
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.storage.index import create_index as jax_create_index
from hyrise_tpu.storage.table import Table as JTable
from hyrise_tpu.types import JoinMode as JJoinMode
from hyrise_tpu.types import PredicateCondition as JCond
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.index_scan import IndexScan
from hyrise_tpu_torch.ops.join import JoinIndex
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.parallel.blocked_dist import BlockedDistributedQuery
from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery, DistributedQuery,
                                                     ShardedCatalog)
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.plan.compiler import PlanNotCompilable
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.index import create_index
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, JoinMode, PredicateCondition
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

N = 4
P = PredicateCondition
_state = {}


def _port_table(name, df):
    cols = []
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_string_dtype(s):
            cols.append(Column.from_numpy(c, DataType.STRING, s.to_numpy(dtype=object),
                                          device="cpu"))
            continue
        kind = {"int32": DataType.INT32, "int64": DataType.INT64,
                "float64": DataType.FLOAT64}[str(s.dtype)]
        cols.append(Column.from_numpy(c, kind, s.to_numpy(dtype=kind.numpy_dtype),
                                      device="cpu"))
    return Table(cols, len(df), name=name)


# "dim" is replicated and carries indexes; "other" is placed by a column
# that is not the join key; "sb" is too large to broadcast
PLACEMENT = {"fact": "k", "dim": None, "other": "w", "sp": "v", "sb": "w"}
INDEXES = {"fact": ["g", "k"], "dim": ["k", "name", ("k", "name")], "other": ["k"],
           "sb": ["k"]}


def _frames():
    rng = np.random.default_rng(0)
    n = 300
    return {
        "fact": pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int64),
                              "g": rng.integers(0, 7, n).astype(np.int32),
                              "v": rng.normal(size=n)}),
        "dim": pd.DataFrame({"k": rng.permutation(48).astype(np.int64),
                             "name": [f"n{i % 5}" for i in range(48)]}),
        "other": pd.DataFrame({"k": rng.integers(0, 40, 97).astype(np.int64),
                               "w": rng.normal(size=97)}),
        "sp": pd.DataFrame({"k": rng.integers(0, 90_000, 3000).astype(np.int64),
                            "v": rng.normal(size=3000)}),
        "sb": pd.DataFrame({"k": rng.permutation(70_000).astype(np.int64),
                            "w": rng.normal(size=70_000)}),
    }


def _env():
    """(port catalog, ShardedCatalog, JAX catalog, JAX ShardedCatalog), the
    indexes created on the stored tables before they were placed."""
    if "env" not in _state:
        cat, jcat = Catalog(device="cpu"), JCatalog()
        for name, df in _frames().items():
            t, jt = _port_table(name, df), JTable.from_pandas(name, df)
            for cols in INDEXES.get(name, ()):
                create_index(t, list(cols) if isinstance(cols, tuple) else cols)
                jax_create_index(jt, list(cols) if isinstance(cols, tuple) else cols)
            cat.add_table(name, t)
            jcat.add_table(name, jt)
        # copies of the catalog as it is now (ShardedCatalog.is_current)
        sc = ShardedCatalog(make_mesh(N, device="cpu"), source=cat)
        jsc = JShardedCatalog(jax_make_mesh(N))
        for name in PLACEMENT:
            t, jt = cat.get_table(name), jcat.get_table(name)
            if PLACEMENT[name] is None:
                sc.add_replicated(name, t)
                jsc.add_replicated(name, jt)
            else:
                sc.add_sharded(name, t, PLACEMENT[name])
                jsc.add_sharded(name, jt, PLACEMENT[name])
        _state["env"] = (cat, sc, jcat, jsc)
    return _state["env"]


def _decisions(q):
    return [q._decisions[id(op)] for op in q.ops if id(op) in q._decisions]


def _same(got, want, ordered=True):
    assert_tables_equal(got.rows() if hasattr(got, "rows") else got,
                        want.rows() if hasattr(want, "rows") else want,
                        ordered=ordered, rel_tol=1e-9)


def _index_ops(q):
    return [op for op in q.ops if op.name in ("IndexScan", "JoinIndex")]


def _against_jax(plan_fn, jplan_fn, ordered=True, jax=True):
    """The eager and the compiled distributed forms: their rows equal each
    other's (the compiled twice) and single node's (as a set: single node
    an IndexScan takes the index, in its order); with `jax`, equal to the
    JAX DistributedCompiledQuery's in rows, decisions and
    exchange_stats(). No IndexScan took an index, no JoinIndex used one."""
    cat, sc, jcat, jsc = _env()
    ref = execute_plan(plan_fn(cat))
    dq = DistributedQuery(plan_fn(cat), sc)
    eager = dq.run()
    _same(eager, ref, ordered=False)
    cq = DistributedCompiledQuery(plan_fn(cat), sc)
    _same(cq.run(), eager, ordered)
    _same(cq.run(), eager, ordered)
    assert cq.last_retries == 0
    assert cq.join_decisions() == dq.join_decisions()
    assert cq.exchange_stats() == dq.exchange_stats()
    for q in (dq, cq):
        ops = _index_ops(q)
        assert ops
        for op in ops:
            if op.name == "IndexScan":
                assert op.performance_data.extra.get("index_fallback") is True
            else:
                assert not op.performance_data.extra.get("index_used")
    if jax:
        jq = JDistributedCompiledQuery(jplan_fn(jcat), jsc)
        _same(cq.run(), jq.run(), ordered)
        assert _decisions(dq) == _decisions(cq._dq) == _decisions(jq)
        assert cq.exchange_stats() == jq.exchange_stats()
        for op in _index_ops(jq):
            if op.name == "JoinIndex":
                assert not op.performance_data.extra.get("index_used")
    return dq, cq


# -- IndexScan ------------------------------------------------------------------------


SCANS = {
    # (table, column, condition, value, value2, extra_equals)
    "sharded_range": ("fact", "g", "LESS_THAN", 3, None, []),
    "sharded_between": ("fact", "k", "BETWEEN", 5, 20, []),
    "replicated_equals": ("dim", "name", "EQUALS", "n2", None, []),
    "replicated_range": ("dim", "k", "GREATER_THAN_EQUALS", 30, None, []),
    "replicated_composite": ("dim", "k", "EQUALS", 7, None, [("name", "n2")]),
    "replicated_absent": ("dim", "name", "EQUALS", "zz", None, []),
}


@pytest.mark.parametrize("case", sorted(SCANS))
def test_index_scan_over_shards(case):
    table, column, cond, v, v2, extra = SCANS[case]

    def plan(c):
        return IndexScan(GetTable(table, c), column, P[cond], v, v2, extra_equals=extra)

    def jplan(c):
        return JIndexScan(JGetTable(table, c), column, JCond[cond], v, v2, extra_equals=extra)

    dq, cq = _against_jax(plan, jplan)
    assert _decisions(dq) == []
    if table == "fact":  # the sharded input is gathered once
        assert cq.exchange_stats()["exchange.gather"]["sites"] == 1


def test_index_scan_under_a_grouped_aggregate():
    def plan(c):
        scan = IndexScan(GetTable("fact", c), "k", P.LESS_THAN_EQUALS, 25)
        return Sort(Aggregate(scan, ["g"], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())]),
                    ["g"])

    def jplan(c):
        scan = JIndexScan(JGetTable("fact", c), "k", JCond.LESS_THAN_EQUALS, 25)
        return JSort(JAggregate(scan, ["g"], [("s", jast.sum_(jast.col("v"))),
                                              ("n", jast.count_())]), ["g"])

    _against_jax(plan, jplan)


# -- JoinIndex ------------------------------------------------------------------------


MODES = ["INNER", "LEFT", "RIGHT", "OUTER", "SEMI", "ANTI", "ANTI_NULL_AS_TRUE"]


def _join_plan(left, right, mode, cond="EQUALS", sort=("k", "v")):
    def plan(c):
        j = JoinIndex(GetTable(left, c), GetTable(right, c), JoinMode[mode], ("k", "k"),
                      P[cond])
        return Sort(j, list(sort))

    def jplan(c):
        j = JJoinIndex(JGetTable(left, c), JGetTable(right, c), JJoinMode[mode], ("k", "k"),
                       JCond[cond])
        return JSort(j, list(sort))

    return plan, jplan


@pytest.mark.parametrize("mode", MODES)
def test_join_index_with_an_indexed_replicated_build_side(mode):
    """dim carries an index on k, and is replicated: the JAX package's
    traced copy has none, and neither has the port's, eagerly too."""
    plan, jplan = _join_plan("fact", "dim", mode)
    _against_jax(plan, jplan, ordered=False)


def test_join_index_non_equi():
    plan, jplan = _join_plan("other", "dim", "INNER", "LESS_THAN", sort=("k", "w"))
    _against_jax(plan, jplan, ordered=False)


@pytest.mark.parametrize("mode", ["INNER", "LEFT", "SEMI", "ANTI"])
def test_join_index_co_partitioned(mode):
    plan, jplan = _join_plan("fact", "fact", mode, sort=("k", "v", "g"))
    dq, _ = _against_jax(plan, jplan, ordered=False)
    assert _decisions(dq) == ["copart"]


@pytest.mark.parametrize("mode", ["INNER", "LEFT", "RIGHT", "OUTER", "SEMI", "ANTI"])
def test_join_index_shuffled(mode):
    """Both sides shuffle by k (RIGHT broadcasts its small build side). SEMI
    and ANTI leave a masked table, whose global aggregate the JAX package
    reads wrongly (ROADMAP C4): they are held to single node only."""
    def plan(c):
        j = JoinIndex(GetTable("sp", c), GetTable("sb", c), JoinMode[mode], ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])

    def jplan(c):
        j = JJoinIndex(JGetTable("sp", c), JGetTable("sb", c), JJoinMode[mode], ("k", "k"))
        return JAggregate(j, [], [("s", jast.sum_(jast.col("v"))), ("n", jast.count_())])

    dq, _ = _against_jax(plan, jplan, jax=mode not in ("SEMI", "ANTI"))
    assert _decisions(dq) == ["broadcast" if mode == "RIGHT" else "shuffle"]


# -- the SQL route ----------------------------------------------------------------


SQL_TEXTS = [
    "SELECT k, g FROM fact WHERE g = 3 ORDER BY k, g",
    "SELECT name, k FROM dim WHERE k BETWEEN 4 AND 11",
    "SELECT f.g, COUNT(*) AS n FROM fact f JOIN dim d ON f.k = d.k WHERE d.name = 'n1' "
    "GROUP BY f.g ORDER BY f.g",
]


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("sql", SQL_TEXTS)
def test_sql_with_indexes_runs_distributed(sql, compiled):
    cat, sc, jcat, jsc = _env()
    want = JSQLPipelineBuilder(sql).with_catalog(jcat).with_distributed_execution(jsc) \
        .create_pipeline().get_result_table().rows()
    for _ in range(2):
        b = SQLPipelineBuilder(sql).with_catalog(cat).with_distributed_execution(sc)
        if compiled:
            b = b.with_compiled_execution()
        p = b.create_pipeline()
        got = p.get_result_table().rows()
        st = p.pipeline_statements[-1]
        assert_tables_equal(got, want, ordered="ORDER BY" in sql, rel_tol=1e-9)
        assert st.last_dist_query is not None and _index_ops(st.last_dist_query)
        assert st.last_compiled is compiled


# -- blocked ------------------------------------------------------------------------


def _sum_count(m, agg, inp):
    return agg(inp, [], [("s", m.sum_(m.col("v"))), ("n", m.count_())])


BLOCKED = {
    "stream_path": (
        lambda c: _sum_count(ast, Aggregate, IndexScan(GetTable("fact", c), "g", P.LESS_THAN, 3)),
        lambda c: _sum_count(jast, JAggregate, JIndexScan(JGetTable("fact", c), "g",
                                                          JCond.LESS_THAN, 3))),
    "join_index": (
        lambda c: _sum_count(ast, Aggregate, JoinIndex(GetTable("fact", c), GetTable("dim", c),
                                                       JoinMode.INNER, ("k", "k"))),
        lambda c: _sum_count(jast, JAggregate, JJoinIndex(JGetTable("fact", c),
                                                          JGetTable("dim", c),
                                                          JJoinMode.INNER, ("k", "k")))),
    "resident_scan": (
        lambda c: _sum_count(ast, Aggregate, JoinIndex(
            GetTable("fact", c), IndexScan(GetTable("dim", c), "name", P.EQUALS, "n3"),
            JoinMode.INNER, ("k", "k"))),
        lambda c: _sum_count(jast, JAggregate, JJoinIndex(
            JGetTable("fact", c), JIndexScan(JGetTable("dim", c), "name", JCond.EQUALS, "n3"),
            JJoinMode.INNER, ("k", "k")))),
}


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("case", sorted(BLOCKED))
def test_blocked_distributed_index_plans(case, compiled):
    cat, sc, jcat, jsc = _env()
    plan, jplan = BLOCKED[case]
    block = 32
    try:
        want = JBlockedDistributedQuery(jplan(jcat), jsc, stream_table="fact",
                                        block_rows=block).run()
    except JPlanNotCompilable as exc:
        assert "IndexScan" in str(exc)
        with pytest.raises(PlanNotCompilable, match="IndexScan"):
            BlockedDistributedQuery(plan(cat), sc, stream_table="fact", block_rows=block,
                                    compiled=compiled)
        return
    bq = BlockedDistributedQuery(plan(cat), sc, stream_table="fact", block_rows=block,
                                 compiled=compiled)
    got = bq.run()
    assert bq.n_blocks >= 2
    _same(got, want)
    _same(bq.run(), want)
    _same(got, execute_plan(plan(cat)))

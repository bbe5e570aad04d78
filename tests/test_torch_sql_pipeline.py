"""The port's SQL pipeline (hyrise_tpu_torch.sql.pipeline) on the CPU: the
plan cache and its five eviction policies (held against the JAX package's
cache on the same access sequence), PREPARE/EXECUTE, `?` parameters, EXPLAIN,
views, SHOW, set operations, statement metrics, DML, CREATE TABLE and the
MVCC switch against the JAX package, the lowering of an index-marked
predicate, the error raised by a missing catalog, and a scalar subquery's
value compared with a float32 column in their common type, under each
physical design (against sqlite)."""

import random
import sqlite3

import numpy as np
import pytest
import torch

from hyrise_tpu.sql.pipeline import SQLQueryCache as JaxQueryCache
from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.misc import AddRowIds, Difference, UnionPositions
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.translator import translate_lqp
from hyrise_tpu_torch.sql import pipeline
from hyrise_tpu_torch.sql.pipeline import (SQLPipelineBuilder, SQLQueryCache,
                                           StatementMetrics, run_sql)
from hyrise_tpu_torch.sql.translator import SQLTranslationError
from hyrise_tpu_torch.storage.block_statistics import attach_block_statistics
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.index import create_index
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)


def _catalog() -> Catalog:
    rng = np.random.default_rng(11)
    n = 40
    t = Table.from_arrays(
        "t", [TableColumnDefinition("a", DataType.INT32),
              TableColumnDefinition("b", DataType.FLOAT64),
              TableColumnDefinition("s", DataType.STRING)],
        [np.arange(n, dtype=np.int32), rng.random(n) * 10,
         np.array(["x", "y", "z"], dtype=object)[np.arange(n) % 3]], device="cpu")
    u = Table.from_arrays(
        "u", [TableColumnDefinition("k", DataType.INT32),
              TableColumnDefinition("w", DataType.STRING)],
        [np.array([1, 2, 3, 50], dtype=np.int32),
         np.array(["one", "two", "three", "fifty"], dtype=object)], device="cpu")
    cat = Catalog()
    cat.add_table("t", t)
    cat.add_table("u", u)
    return cat


def _rows(sql, cat, **kw):
    return run_sql(sql, cat).rows()


def _ops(plan, seen=None):
    seen = {} if seen is None else seen
    if id(plan) not in seen:
        seen[id(plan)] = plan
        for i in plan.inputs:
            _ops(i, seen)
    return list(seen.values())


# -- the plan cache --------------------------------------------------------------


@pytest.mark.parametrize("policy", ["lru", "lru_k", "gds", "gdfs", "random"])
def test_query_cache_policy_matches_jax(policy):
    """The same puts and gets leave the same keys in both packages' caches
    ('random' evicts with the seeded module generator)."""
    rng = np.random.default_rng(3)
    got, want = SQLQueryCache(4, policy), JaxQueryCache(4, policy)
    for step in range(200):
        key = f"q{int(rng.integers(0, 9))}"
        cost, size = float(rng.integers(1, 5)), float(rng.integers(1, 3))
        for cache in (got, want):
            random.seed(step)
            if cache.get(key) is None:
                cache.put(key, key.upper(), cost=cost, size=size)
        assert sorted(got._d) == sorted(want._d), step
        assert len(got._d) <= 4
    assert got.get(next(iter(got._d))) is not None
    got.clear()
    assert not got._d and got.get("q1") is None


def test_query_cache_rejects_unknown_policy():
    with pytest.raises(AssertionError):
        SQLQueryCache(4, "fifo")


def test_lru_evicts_the_least_recently_used():
    c = SQLQueryCache(2, "lru")
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3


def test_plan_cache_hit_reuses_the_plan_and_gives_the_same_rows():
    """A hit reuses the cached optimized plan (no translation to an LQP, no
    optimizer) and translates an operator tree of its own from it, so that
    two callers never share operators and their outputs (ROADMAP C19)."""
    cat = _catalog()
    pipeline._plan_cache.clear()
    sql = "SELECT s, SUM(b), COUNT(*) FROM t WHERE a < 30 GROUP BY s ORDER BY s"
    first = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline()
    rows = first.get_result_table().rows()
    m1 = first.pipeline_statements[0].metrics
    assert isinstance(m1, StatementMetrics) and not m1.cache_hit
    assert m1.parse_s > 0 and m1.translate_s > 0 and m1.optimize_s > 0 \
        and m1.compile_s > 0 and m1.execute_s > 0
    second = SQLPipelineBuilder(sql).with_catalog(cat).create_pipeline()
    assert second.get_result_table().rows() == rows
    m2 = second.pipeline_statements[0].metrics
    assert m2.cache_hit and m2.translate_s == 0.0 and m2.optimize_s == 0.0 \
        and m2.compile_s > 0
    assert second.pipeline_statements[0].last_plan is not \
        first.pipeline_statements[0].last_plan
    # another catalog never gets this catalog's plan
    other = _catalog()
    third = SQLPipelineBuilder(sql).with_catalog(other).create_pipeline()
    assert third.get_result_table().rows() == rows
    assert not third.pipeline_statements[0].metrics.cache_hit
    # and the cache can be bypassed
    fourth = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline()
    fourth.get_result_table()
    assert not fourth.pipeline_statements[0].metrics.cache_hit


def test_cached_text_on_four_threads_gives_one_threads_answer():
    """ROADMAP C19: one cached TPC-H text (Q3 at SF 0.01) runs on 4 threads,
    5 times each, all at once; every answer equals one thread's alone, and
    every run after the first is a cache hit."""
    import sys
    import threading

    from hyrise_tpu_torch.tpch import dbgen
    from hyrise_tpu_torch.tpch.queries import TPCH_SQL

    cat = Catalog(device="cpu")
    for name, t in dbgen.generate_tables(0.01, device="cpu").items():
        cat.add_table(name, t)
    pipeline._plan_cache.clear()
    want = run_sql(TPCH_SQL[3], cat).rows()
    assert want
    answers, hits, errors = [], [], []

    def run():
        try:
            for _ in range(5):
                p = SQLPipelineBuilder(TPCH_SQL[3]).with_catalog(cat).create_pipeline()
                answers.append(p.get_result_table().rows())
                hits.append(p.pipeline_statements[0].metrics.cache_hit)
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert len(answers) == 20 and all(hits)
    for got in answers:
        assert got == want


def test_filter_aggregate_chain_becomes_the_fused_operator():
    cat = _catalog()
    p = SQLPipelineBuilder("SELECT s, SUM(b) FROM t WHERE a >= 10 AND b < 9 GROUP BY s") \
        .with_catalog(cat).dont_cache_query_plans().create_pipeline()
    got = p.get_result_table().rows()
    fused = [o for o in _ops(p.pipeline_statements[0].last_plan)
             if isinstance(o, FusedFilterAggregate)]
    assert len(fused) == 1 and fused[0].fell_back is False
    t = cat.get_table("t")
    a, b = t.column("a").data.numpy(), t.column("b").data.numpy()
    s = t.column("s").decode(t.num_rows)
    want = [(k, b[(a >= 10) & (b < 9) & (s == k)].sum()) for k in ("x", "y", "z")]
    assert [r[0] for r in got] == [w[0] for w in want]
    np.testing.assert_allclose([r[1] for r in got], [w[1] for w in want], rtol=1e-12)
    # without a predicate it stays a plain Aggregate
    p = SQLPipelineBuilder("SELECT s, SUM(b) FROM t GROUP BY s").with_catalog(cat) \
        .dont_cache_query_plans().create_pipeline()
    p.get_result_table()
    ops = _ops(p.pipeline_statements[0].last_plan)
    assert any(type(o) is Aggregate for o in ops)
    assert not any(isinstance(o, FusedFilterAggregate) for o in ops)


# -- statements ------------------------------------------------------------------


def test_prepare_and_execute():
    cat = _catalog()
    assert _rows("PREPARE p1 FROM 'SELECT a FROM t WHERE a > ? AND s = ?'", cat) == []
    assert _rows("EXECUTE p1 (36, 'x')", cat) == [(39,)]
    assert _rows("EXECUTE p1 (-1, 'z')", cat)[:2] == [(2,), (5,)]
    with pytest.raises(SQLTranslationError):
        _rows("EXECUTE no_such_statement (1)", cat)


def test_with_params_substitutes_typed_literals():
    cat = _catalog()
    p = SQLPipelineBuilder("SELECT w FROM u WHERE k = ? OR w = ?").with_catalog(cat) \
        .with_params([2, "it's ? quoted"]).create_pipeline()
    assert p.get_result_table().rows() == [("two",)]
    assert not p.pipeline_statements[0].metrics.cache_hit  # never cached


def test_explain_returns_the_optimized_plan_text():
    cat = _catalog()
    lines = [r[0] for r in _rows("EXPLAIN SELECT a FROM t WHERE a > 5", cat)]
    assert any("[Predicate]" in ln for ln in lines)
    assert any("[StoredTable] t" in ln for ln in lines)


def test_views_show_and_drop():
    cat = _catalog()
    _rows("CREATE VIEW big AS SELECT a, s FROM t WHERE a >= 38", cat)
    assert cat.has_view("big")
    assert _rows("SELECT a FROM big WHERE s = 'z'", cat) == [(38,)]
    assert _rows("SHOW TABLES", cat) == [("t",), ("u",)]
    assert _rows("SHOW COLUMNS u", cat) == [("k", "int32", 0), ("w", "string", 0)]
    _rows("DROP VIEW big", cat)
    assert not cat.has_view("big")
    _rows("DROP TABLE u", cat)
    assert cat.table_names() == ["t"]


def test_several_statements_return_the_last_result():
    cat = _catalog()
    assert _rows("CREATE VIEW v AS SELECT a FROM t WHERE a < 2; SELECT a FROM v", cat) \
        == [(0,), (1,)]


def test_select_without_from_and_scalar_subquery():
    cat = _catalog()
    assert _rows("SELECT 1 + 2", cat) == [(3,)]
    assert _rows("SELECT a FROM t WHERE a = (SELECT MAX(k) FROM u WHERE k < 10)", cat) \
        == [(3,)]
    # an empty scalar subquery is NULL: nothing compares equal to it
    assert _rows("SELECT a FROM t WHERE a = (SELECT k FROM u WHERE k > 99)", cat) == []


def test_set_operations_use_the_ported_operators():
    cat = _catalog()
    sql = "SELECT a FROM t WHERE a < 4 UNION SELECT k FROM u"
    p = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline()
    assert sorted(p.get_result_table().rows()) == [(0,), (1,), (2,), (3,), (50,)]
    assert any(isinstance(o, UnionPositions)
               for o in _ops(p.pipeline_statements[0].last_plan))
    sql = "SELECT a FROM t WHERE a < 4 EXCEPT SELECT k FROM u"
    p = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline()
    assert sorted(p.get_result_table().rows()) == [(0,)]
    assert any(isinstance(o, Difference) for o in _ops(p.pipeline_statements[0].last_plan))
    assert sorted(_rows("SELECT a FROM t WHERE a < 4 INTERSECT SELECT k FROM u", cat)) \
        == [(1,), (2,), (3,)]
    assert len(_rows("SELECT a FROM t WHERE a < 4 UNION ALL SELECT k FROM u", cat)) == 8


def test_difference_compares_whole_rows_with_nulls_and_floats():
    """Float columns (-0.0 equals 0.0), strings over different dictionaries
    and NULLs (two NULLs are one value to a set operation)."""
    def table(name, f, s, valid):
        return Table.from_arrays(
            name, [TableColumnDefinition("f", DataType.FLOAT64, True),
                   TableColumnDefinition("s", DataType.STRING)],
            [np.array(f), np.array(s, dtype=object)], [np.array(valid), None],
            device="cpu")
    cat = Catalog()
    cat.add_table("l", table("l", [0.0, 1.5, 2.5, 9.0, 9.0], ["a", "b", "c", "d", "d"],
                             [True, True, True, False, True]))
    cat.add_table("r", table("r", [-0.0, 1.5, 7.0, 3.0], ["a", "zz", "c", "d"],
                             [True, True, True, False]))
    got = sorted(_rows("SELECT f, s FROM l EXCEPT SELECT f, s FROM r", cat),
                 key=lambda r: r[1])
    assert got == [(1.5, "b"), (2.5, "c"), (9.0, "d")]


def test_correlated_subquery_adds_row_ids():
    cat = _catalog()
    sql = "SELECT a FROM t WHERE b > (SELECT AVG(b) FROM t t2 WHERE t2.a < t.a)"
    p = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline()
    got = sorted(r[0] for r in p.get_result_table().rows())
    assert any(isinstance(o, AddRowIds) for o in _ops(p.pipeline_statements[0].last_plan))
    b = cat.get_table("t").column("b").data.numpy()
    assert got == [i for i in range(1, 40) if b[i] > b[:i].mean()]


# -- DML, CREATE TABLE and MVCC against the JAX package -----------------------------


def _dml_catalogs():
    """(port catalog, JAX catalog) over _catalog()'s tables, with MVCC on u
    in both."""
    from hyrise_tpu.concurrency.transaction import MvccData as JaxMvccData
    from hyrise_tpu.concurrency.transaction import reset_default_transaction_manager
    from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
    from hyrise_tpu.storage.table import Table as JaxTable
    from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
    from hyrise_tpu.types import DataType as JaxType
    from hyrise_tpu_torch.concurrency.transaction import MvccData

    reset_default_transaction_manager()
    cat = _catalog()
    jcat = JaxCatalog()
    for name in cat.table_names():
        t = cat.get_table(name)
        jt = JaxTable.from_arrays(
            name, [JaxDef(c.name, JaxType(c.dtype.value)) for c in t.columns],
            [c.decode(t.num_rows) if c.dtype is DataType.STRING else c.data.numpy()
             for c in t.columns])
        if name == "u":
            jt.mvcc = JaxMvccData.for_new_table(jt.num_rows, jt.capacity)
            t.mvcc = MvccData.for_new_table(t.num_rows, t.capacity, device="cpu")
        jcat.add_table(name, jt)
    return cat, jcat


def _u_rows(run, cat):
    return sorted(tuple(v.item() if hasattr(v, "item") else v for v in r)
                  for r in run("SELECT k, w FROM u", cat, use_mvcc=True).rows())


@pytest.mark.parametrize("sql", [
    "INSERT INTO u VALUES (7, 'seven')",
    "UPDATE u SET k = 1 WHERE k = 2",
    "DELETE FROM u WHERE k = 2",
    "CREATE TABLE n (x int)",
])
def test_dml_runs_like_jax(sql):
    from hyrise_tpu.sql.pipeline import run_sql as jax_run_sql
    cat, jcat = _dml_catalogs()
    run_sql(sql, cat)
    jax_run_sql(sql, jcat)
    assert cat.table_names() == jcat.table_names()
    assert _u_rows(run_sql, cat) == _u_rows(jax_run_sql, jcat)


def _validate_u(pkg):
    return pkg.L.ValidateNode(pkg.L.StoredTableNode("u"))


def _insert_u(pkg):
    return pkg.L.InsertNode("u", pkg.L.StoredTableNode("u"))


def _delete_u(pkg):
    L = pkg.L
    return L.DeleteNode("u", L.PredicateNode(
        pkg.ast.col("k") > pkg.ast.lit(1),
        L.ValidateNode(L.AddRowIdsNode(L.StoredTableNode("u")))))


def _create_n(pkg):
    return pkg.L.CreateTableNode("n", [pkg.Def("x", pkg.DataType.INT32)])


@pytest.mark.parametrize("make", [_validate_u, _insert_u, _delete_u, _create_n],
                         ids=lambda f: f.__name__)
def test_dml_nodes_translate_and_run_like_jax(make):
    """The same node in both physical translators: the same operator, run
    in one transaction, leaves the same visible rows of u."""
    from types import SimpleNamespace

    from hyrise_tpu import types as jax_types
    from hyrise_tpu.concurrency.transaction import TransactionManager as JaxTM
    from hyrise_tpu.expression import ast as jax_ast
    from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
    from hyrise_tpu.plan import lqp as JaxL
    from hyrise_tpu.plan.translator import translate_lqp as jax_translate_lqp
    from hyrise_tpu.sql.pipeline import run_sql as jax_run_sql
    from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
    from hyrise_tpu_torch.concurrency.transaction import TransactionManager
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.base import execute_plan

    port = SimpleNamespace(L=L, ast=ast, Def=TableColumnDefinition, DataType=DataType)
    jax = SimpleNamespace(L=JaxL, ast=jax_ast, Def=JaxDef, DataType=jax_types.DataType)
    cat, jcat = _dml_catalogs()
    got, want = [], []
    for pkg, run, c, translate, execute, tm, out in (
            (port, run_sql, cat, translate_lqp, execute_plan, TransactionManager(), got),
            (jax, jax_run_sql, jcat, jax_translate_lqp, jax_execute_plan, JaxTM(), want)):
        op = translate(make(pkg), c)
        ctx = tm.new_transaction_context()
        result = execute(op, ctx)
        ctx.commit()
        out.extend([op.name, result.num_rows, c.table_names(), _u_rows(run, c)])
    assert got == want


@pytest.mark.parametrize("mvcc", ["on", "off"])
def test_mvcc_switch_matches_jax(mvcc):
    """with_mvcc(True) validates u's rows; with_mvcc(False) and disable_mvcc()
    read every stored row, a deleted one included."""
    from hyrise_tpu.sql.pipeline import SQLPipelineBuilder as JaxBuilder
    from hyrise_tpu.sql.pipeline import run_sql as jax_run_sql
    cat, jcat = _dml_catalogs()
    run_sql("DELETE FROM u WHERE k = 2", cat)
    jax_run_sql("DELETE FROM u WHERE k = 2", jcat)
    rows = []
    for builder, c in ((SQLPipelineBuilder, cat), (JaxBuilder, jcat)):
        b = builder("SELECT k FROM u ORDER BY k").with_catalog(c)
        b = b.with_mvcc(True) if mvcc == "on" else b.with_mvcc(False).disable_mvcc()
        rows.append([int(r[0]) for r in b.create_pipeline().get_result_table().rows()])
    assert rows[0] == rows[1] == ([1, 3, 50] if mvcc == "on" else [1, 2, 3, 50])


def test_index_marked_predicate_raises_in_the_physical_translator():
    """A marked predicate no longer raises: it becomes an IndexScan of the
    stored table (storage/index.py, ops/index_scan.py), which answers it
    through the index when there is one and as a TableScan when there is
    none. The test keeps the name it had while the translator raised."""
    from hyrise_tpu_torch.expression import ast
    from hyrise_tpu_torch.ops.base import execute_plan
    from hyrise_tpu_torch.ops.index_scan import IndexScan
    from hyrise_tpu_torch.types import PredicateCondition
    cat = _catalog()
    for indexed in (False, True):
        if indexed:
            create_index(cat.get_table("t"), "a")
        node = L.PredicateNode(ast.col("a") > ast.lit(1), L.StoredTableNode("t"))
        node.use_index = ("a", PredicateCondition.GREATER_THAN, 1, None)
        op = translate_lqp(node, cat)
        assert isinstance(op, IndexScan)
        want = execute_plan(translate_lqp(
            L.PredicateNode(ast.col("a") > ast.lit(1), L.StoredTableNode("t")), cat))
        assert sorted(execute_plan(op).rows()) == sorted(want.rows())
        assert op.performance_data.extra.get("index_fallback", False) is not indexed


def test_missing_catalog_raises():
    with pytest.raises(ValueError, match="with_catalog"):
        SQLPipelineBuilder("SELECT 1").create_pipeline()


def test_catalog_device_is_where_its_tables_live():
    assert Catalog(device="cpu").device == torch.device("cpu")
    assert Catalog().device == torch.device("cuda")  # the card, if nothing says else
    assert _catalog().device == torch.device("cpu")


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("design", [None, "block statistics", "index"])
def test_a_scalar_subquery_compares_in_the_common_type(compiled, design):
    """A float32 column against an uncorrelated AVG compares in float64, as
    its correlated form and sqlite do; the average rounded to float32 would
    drop the rows that sit on the rounded value (TPC-H Q22 on some data).
    Here the float64 average lies a third of a float32 step below v, the
    blocks' maximum. A physical design changes no answer: block statistics
    prune in the same type, and an index serves no subquery's value (the
    index rule runs before the subqueries are resolved)."""
    v = np.float32(5004.58)
    u = np.nextafter(v, np.float32(-np.inf))
    x = np.array([v, v, u], dtype=np.float32)
    avg = x.astype(np.float64).mean()
    assert np.float32(avg) == v and float(v) > avg
    t = Table.from_arrays("t", [TableColumnDefinition("x", DataType.FLOAT32)], [x],
                          device="cpu")
    if design == "block statistics":
        attach_block_statistics(t, block_rows=2)
        assert t.block_stats.columns["x"].maxs.tolist() == [v, u]
    elif design == "index":
        create_index(t, "x")
    cat = Catalog()
    cat.add_table("t", t)
    db = sqlite3.connect(":memory:")
    db.execute("CREATE TABLE t (x REAL)")
    db.executemany("INSERT INTO t VALUES (?)", [(float(a),) for a in x])
    where = ["x > (SELECT AVG(x) FROM t)", "(SELECT AVG(x) FROM t) < x",
             "x >= (SELECT AVG(x) FROM t)"]
    # the rows go through TableScan, which prunes blocks; COUNT(*) through
    # the fused filter-aggregate, which does not
    for text in [f"SELECT x FROM t WHERE {w}" for w in where] + \
            [f"SELECT COUNT(*) AS n FROM t WHERE {w}" for w in where]:
        frame = SQLPipelineBuilder(text).with_catalog(cat) \
            .with_compiled_execution(compiled).create_pipeline().get_result_table().to_pandas()
        want = [r[0] for r in db.execute(text)]
        assert want in ([float(v)] * 2, [2])
        assert frame.iloc[:, 0].tolist() == want, text

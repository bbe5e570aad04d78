"""IndexScan and JoinIndex in capacity mode (hyrise_tpu_torch/ops/index_scan.py
and ops/join.py under plan/compiler.py's CompiledQuery) on CPU tensors,
against the JAX CompiledQuery over the same tables.

The JAX CompiledQuery's traced tables carry no index, so there an IndexScan
runs its TableScan fallback (rows in table order, `index_fallback` set) and
a JoinIndex sorts its build side (`index_used` False). The port's capacity
mode does the same, and reads no index at all:

- the six range conditions with literals present, absent, below and above
  the column, on integer and float columns, a string column
  (GroupKeyIndex), a float column with NaN and NULLs (ROADMAP C15), a
  composite index with `extra_equals` (covered, not covered, an absent
  string), and the conditions that never take an index: rows in order and
  `index_fallback` equal to the JAX package's;
- a second run retries nothing, and runs with every index lookup made to
  raise; an index created or replaced after the first run leaves the answer
  right;
- the SQL route with indexes through `with_compiled_execution` against the
  JAX pipeline's, its second run from the cache with no eager read;
- the streamed forms: an IndexScan on the stream path is refused, one on a
  resident table runs, in BlockedCompiledQuery and SegmentedQuery (both
  modes), as the JAX BlockedCompiledQuery and SegmentedQuery do;
- JoinIndex in every mode: the rows and `index_used` of the JAX
  CompiledQuery."""

import numpy as np
import pytest
import torch

import hyrise_tpu.ops as jax_ops
from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.index_scan import IndexScan as JIndexScan
from hyrise_tpu.ops.join import Join as JJoin
from hyrise_tpu.ops.join import JoinIndex as JJoinIndex
from hyrise_tpu.plan.blocked import BlockedCompiledQuery as JBlockedCompiledQuery
from hyrise_tpu.plan.compiler import CompiledQuery as JCompiledQuery
from hyrise_tpu.plan.compiler import PlanNotCompilable as JPlanNotCompilable
from hyrise_tpu.plan.segmented import SegmentedQuery as JSegmentedQuery
from hyrise_tpu.sql.pipeline import SQLPipelineBuilder as JSQLPipelineBuilder
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.storage.index import create_index as jax_create_index
from hyrise_tpu.storage.table import Table as JTable
from hyrise_tpu.storage.table import TableColumnDefinition as JDef
from hyrise_tpu.types import AggregateFunction as JF
from hyrise_tpu.types import DataType as JType
from hyrise_tpu.types import JoinMode as JJoinMode
from hyrise_tpu.types import PredicateCondition as JCond
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops import index_scan as index_scan_module
from hyrise_tpu_torch.ops import join as join_module
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.index_scan import IndexScan
from hyrise_tpu_torch.ops.join import Join, JoinIndex
from hyrise_tpu_torch.plan.blocked import BlockedCompiledQuery, BlockedQuery
from hyrise_tpu_torch.plan.compiler import CompiledQuery, PlanNotCompilable, eager_reads
from hyrise_tpu_torch.plan.segmented import SegmentedQuery
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.index import create_index
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import AggregateFunction, JoinMode, PredicateCondition

torch.set_num_threads(1)

P = PredicateCondition
CONDS = ["EQUALS", "LESS_THAN", "LESS_THAN_EQUALS", "GREATER_THAN",
         "GREATER_THAN_EQUALS", "BETWEEN"]
N = 1500


def _port_table(jt: JTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return table_from_numpy(jt.name, cols, jt.num_rows, None, device="cpu",
                            unique=[c.name for c in jt.columns if c.unique])


def _values(dtype: str, rng, n: int = N):
    """n values with many ties (about 40 distinct) of the type, floats exact
    in float32, so that both packages compare them alike."""
    keys = rng.integers(0, 40, n)
    if dtype == "string":
        return np.array([f"s{k:02d}" for k in keys], dtype=object)
    if dtype.startswith("int"):
        return (keys * 3 - 30).astype(dtype)
    return (keys / 4 - 3).astype(dtype)


def _envs(tables):
    """(port catalog, JAX catalog) over the JAX tables `tables` and their
    port copies."""
    cat, jcat = Catalog(device="cpu"), JCatalog()
    for jt in tables:
        jcat.add_table(jt.name, jt)
        cat.add_table(jt.name, _port_table(jt))
    return cat, jcat


def _column_table(dtype: str, seed: int = 0, nan: bool = False) -> JTable:
    rng = np.random.default_rng(seed)
    values = _values(dtype, rng)
    if nan:
        values[rng.random(N) < 0.05] = np.nan
    return JTable.from_arrays(
        "t", [JDef("c", JType(dtype), True), JDef("row", JType.INT32)],
        [values, np.arange(N, dtype=np.int32)], [rng.random(N) >= 0.1, None])


def _literals(dtype: str, present: np.ndarray):
    """Present, absent, below the column and above it."""
    if dtype == "string":
        words = sorted(set(present))
        return [words[len(words) // 2], "s10x", "a", "zz"]
    present = np.asarray(present, dtype=np.float64 if dtype.startswith("float") else dtype)
    present = present[~np.isnan(present)] if dtype.startswith("float") else present
    lo, hi, mid = present.min(), present.max(), np.sort(present)[len(present) // 2]
    if dtype.startswith("int"):
        return [int(mid), int(mid) + 1, int(lo) - 7, int(hi) + 7]
    return [float(mid), float(mid) + 0.125, float(lo) - 1.0, float(hi) + 1.0]


def _both(plan, jplan, cat, jcat):
    """The port's CompiledQuery and the JAX one over the plans, run: rows
    equal in order; the port's second run equal and with no retry."""
    cq, jcq = CompiledQuery(plan, cat), JCompiledQuery(jplan, jcat)
    got, want = cq.run().rows(), jcq.run().rows()
    assert got == want
    assert cq.run().rows() == want and cq.last_retries == 0
    return cq


def _index_scans(cat, jcat, cond, lits, extra=(), column="c"):
    for v in lits:
        v2 = lits[(lits.index(v) + 1) % len(lits)]
        scan = IndexScan(GetTable("t", cat), column, P[cond], v, v2, extra_equals=list(extra))
        jscan = JIndexScan(jax_ops.GetTable("t", jcat), column, JCond[cond], v, v2,
                           extra_equals=list(extra))
        _both(scan, jscan, cat, jcat)
        assert scan.performance_data.extra.get("index_fallback") is True
        assert jscan.performance_data.extra.get("index_fallback") is True


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "string"])
def test_index_scan_compiled_equals_the_jax_compiled_query(dtype, cond):
    jt = _column_table(dtype, seed=len(dtype))
    cat, jcat = _envs([jt])
    create_index(cat.get_table("t"), "c")
    jax_create_index(jt, "c")
    t = cat.get_table("t")
    present = t.column("c").decode(t.capacity)[t.column("c").validity.numpy()]
    _index_scans(cat, jcat, cond, _literals(dtype, present))


@pytest.mark.parametrize("cond", CONDS)
def test_index_scan_compiled_over_nan_and_null(cond):
    """ROADMAP C15: the JAX package's eager IndexScan returns NaN rows; its
    compiled form scans, and so does the port's."""
    jt = _column_table("float64", seed=13, nan=True)
    cat, jcat = _envs([jt])
    create_index(cat.get_table("t"), "c")
    jax_create_index(jt, "c")
    t = cat.get_table("t")
    present = t.column("c").decode(t.capacity)[t.column("c").validity.numpy()]
    _index_scans(cat, jcat, cond, _literals("float64", present))


@pytest.mark.parametrize("cond", ["NOT_EQUALS", "LIKE", "IS_NULL", "IN"])
def test_index_scan_compiled_without_a_range(cond):
    jt = _column_table("string", seed=5)
    cat, jcat = _envs([jt])
    create_index(cat.get_table("t"), "c")
    jax_create_index(jt, "c")
    value = {"NOT_EQUALS": "s07", "LIKE": "s1%", "IN": ["s01", "s33"]}.get(cond)
    scan = IndexScan(GetTable("t", cat), "c", P[cond], value)
    jscan = JIndexScan(jax_ops.GetTable("t", jcat), "c", JCond[cond], value)
    _both(scan, jscan, cat, jcat)
    assert scan.performance_data.extra.get("index_fallback") is True


def _composite_table() -> JTable:
    rng = np.random.default_rng(7)
    b_valid = np.ones(N, dtype=bool)
    b_valid[rng.choice(N, 40, replace=False)] = False
    return JTable.from_arrays(
        "t", [JDef("a", JType.INT32), JDef("b", JType.INT64, True), JDef("s", JType.STRING),
              JDef("v", JType.FLOAT32)],
        [rng.integers(0, 20, N).astype(np.int32), rng.integers(0, 50, N).astype(np.int64),
         rng.choice(["red", "green", "blue", "teal"], N).astype(object),
         rng.normal(size=N).astype(np.float32)],
        [None, b_valid, None, None])


@pytest.mark.parametrize("case", ["covered", "prefix", "absent", "uncovered", "not_equals"])
def test_composite_index_scan_compiled(case):
    jt = _composite_table()
    cat, jcat = _envs([jt])
    for cols in (["a", "s"], ["a", "b", "s"]):
        create_index(cat.get_table("t"), cols)
        jax_create_index(jt, cols)
    cond, value, extra = {
        "covered": ("EQUALS", 7, [("s", "green")]),
        "prefix": ("EQUALS", 3, [("b", 17)]),
        "absent": ("EQUALS", 7, [("s", "mauve")]),
        "uncovered": ("EQUALS", 7, [("v", 0.5), ("s", "red")]),
        "not_equals": ("LESS_THAN", 7, [("s", "blue")]),
    }[case]
    _index_scans(cat, jcat, cond, [value], extra, column="a")


def _no_index_lookups(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an index was read in capacity mode")

    monkeypatch.setattr(index_scan_module, "get_index", refuse)
    monkeypatch.setattr(index_scan_module, "find_composite_index", refuse)
    monkeypatch.setattr(join_module, "get_index", refuse)


def test_index_created_after_the_first_run(monkeypatch):
    """A compiled IndexScan reads no index: created or replaced after the
    first run, the next run answers over the table as before; and with every
    index lookup made to raise, runs go on."""
    jt = _column_table("int32", seed=3)
    cat, jcat = _envs([jt])
    jax_create_index(jt, "c")
    plan = IndexScan(GetTable("t", cat), "c", P.LESS_THAN, 0)
    want = JCompiledQuery(JIndexScan(jax_ops.GetTable("t", jcat), "c", JCond.LESS_THAN, 0),
                          jcat).run().rows()
    cq = CompiledQuery(plan, cat)
    assert cq.run().rows() == want  # no index yet
    create_index(cat.get_table("t"), "c")
    assert cq.run().rows() == want
    old = cat.get_table("t").indexes["c"]
    create_index(cat.get_table("t"), "c")
    assert cat.get_table("t").indexes["c"] is not old
    assert cq.run().rows() == want and cq.last_retries == 0
    with monkeypatch.context() as m:
        _no_index_lookups(m)
        assert cq.run().rows() == want
        assert CompiledQuery(IndexScan(GetTable("t", cat), "c", P.LESS_THAN, 0),
                             cat).run().rows() == want
    # eagerly the index serves, in its own order: the same rows
    eager = IndexScan(GetTable("t", cat), "c", P.LESS_THAN, 0)
    assert sorted(execute_plan(eager).rows(), key=lambda r: r[1]) == want
    assert "index_fallback" not in eager.performance_data.extra


SQL_TEXTS = [
    "SELECT c, row FROM t WHERE c = 6",
    "SELECT row FROM t WHERE c < -3",
    "SELECT row FROM t WHERE c BETWEEN 0 AND 9",
    "SELECT row, c FROM t WHERE c >= 60 ORDER BY row DESC",
    "SELECT COUNT(*) AS n, SUM(row) AS s FROM (SELECT row FROM t WHERE c > 30) x",
    "SELECT row FROM t WHERE c = 6 AND s = 'w2'",
    "SELECT t.row, u.w FROM t JOIN u ON t.c = u.k WHERE t.c <= 0",
]


def _sql_tables():
    rng = np.random.default_rng(21)
    t = JTable.from_arrays(
        "t", [JDef("c", JType.INT32), JDef("row", JType.INT32), JDef("s", JType.STRING)],
        [_values("int32", rng), np.arange(N, dtype=np.int32),
         np.array([f"w{k}" for k in rng.integers(0, 4, N)], dtype=object)])
    u = JTable.from_arrays("u", [JDef("k", JType.INT32), JDef("w", JType.STRING)],
                           [np.arange(-30, 90, 3, dtype=np.int32),
                            np.array([f"u{i}" for i in range(40)], dtype=object)])
    return t, u


@pytest.mark.parametrize("sql", SQL_TEXTS)
def test_sql_with_indexes_compiled_equals_the_jax_pipeline(sql):
    jt, ju = _sql_tables()
    cat, jcat = _envs([jt, ju])
    for name, cols in (("t", "c"), ("t", ["c", "s"]), ("u", "k")):
        create_index(cat.get_table(name), cols)
        jax_create_index(jcat.get_table(name), cols)
    want = JSQLPipelineBuilder(sql).with_catalog(jcat).with_compiled_execution() \
        .create_pipeline().get_result_table().rows()
    runs = []
    for _ in range(2):
        before = eager_reads()
        p = SQLPipelineBuilder(sql).with_catalog(cat).with_compiled_execution().create_pipeline()
        runs.append((p.get_result_table().rows(), p.pipeline_statements[-1],
                     eager_reads() - before))
    (first, st1, _), (second, st2, reads) = runs
    assert first == want and second == want
    assert st1.last_compiled and st2.last_compiled
    assert st2.last_compiled_query is st1.last_compiled_query and st2.metrics.cache_hit
    assert reads == 0  # the second run is a replay: no eager read
    scans = [op for op in st2.last_compiled_query.ops if isinstance(op, IndexScan)]
    assert scans and all(op.performance_data.extra.get("index_fallback") for op in scans)


# -- the streamed forms and JoinIndex -------------------------------------------------


def _stream_tables():
    rng = np.random.default_rng(2)
    n = 4096
    fact = JTable.from_arrays(
        "fact", [JDef("k", JType.INT64), JDef("a", JType.INT32), JDef("v", JType.FLOAT64)],
        [rng.integers(0, 40, n).astype(np.int64), rng.integers(0, 100, n).astype(np.int32),
         rng.normal(size=n)])
    dim = JTable.from_arrays("dim", [JDef("k", JType.INT64), JDef("b", JType.INT32)],
                             [np.arange(40, dtype=np.int64),
                              rng.integers(0, 5, 40).astype(np.int32)])
    cat, jcat = _envs([fact, dim])
    for name, column in (("fact", "a"), ("dim", "k"), ("dim", "b")):
        create_index(cat.get_table(name), column)
        jax_create_index(jcat.get_table(name), column)
    return cat, jcat


def _sum_count(m, agg, inp):
    return agg(inp, [], [("s", m.AggregateExpr(AggregateFunction.SUM if m is ast else JF.SUM,
                                               m.ColumnRef("v"))),
                         ("c", m.AggregateExpr(AggregateFunction.COUNT if m is ast else JF.COUNT,
                                               None))])


STREAM_PLANS = {
    "stream_path": lambda c, port: _sum_count(
        ast if port else jast, Aggregate if port else JAggregate,
        (IndexScan(GetTable("fact", c), "a", P.LESS_THAN, 10) if port else
         JIndexScan(jax_ops.GetTable("fact", c), "a", JCond.LESS_THAN, 10))),
    "resident": lambda c, port: _sum_count(
        ast if port else jast, Aggregate if port else JAggregate,
        (Join(GetTable("fact", c), IndexScan(GetTable("dim", c), "b", P.EQUALS, 2),
              JoinMode.INNER, ("k", "k")) if port else
         JJoin(jax_ops.GetTable("fact", c), JIndexScan(jax_ops.GetTable("dim", c), "b",
                                                       JCond.EQUALS, 2),
               JJoinMode.INNER, ("k", "k")))),
    "join_index": lambda c, port: _sum_count(
        ast if port else jast, Aggregate if port else JAggregate,
        (JoinIndex(GetTable("fact", c), GetTable("dim", c), JoinMode.INNER, ("k", "k"))
         if port else JJoinIndex(jax_ops.GetTable("fact", c), jax_ops.GetTable("dim", c),
                                 JJoinMode.INNER, ("k", "k")))),
}

PORT_STREAMED = {
    "blocked": lambda p, c: BlockedQuery(p, c, block_rows=1024),
    "compiled_blocked": lambda p, c: BlockedCompiledQuery(p, c, block_rows=1024),
    "segmented": lambda p, c: SegmentedQuery(p, c, block_rows=1024, resident_rows=2048),
    "compiled_segmented": lambda p, c: SegmentedQuery(p, c, block_rows=1024,
                                                      resident_rows=2048, compiled=True),
}


def _outcome(make, refused):
    try:
        return make().rows()
    except refused as exc:
        return ("refused", str(exc))


@pytest.mark.parametrize("form", sorted(PORT_STREAMED))
@pytest.mark.parametrize("plan", sorted(STREAM_PLANS))
def test_streamed_forms_take_index_plans_as_the_jax_package(plan, form):
    """The JAX BlockedCompiledQuery stands for the blocked forms, its
    SegmentedQuery for the segmented ones: the same refusal (an IndexScan
    on the stream path is not row-distributive), or the same answer."""
    cat, jcat = _stream_tables()
    jax_form = (lambda p, c: JBlockedCompiledQuery(p, c, block_rows=1024)) \
        if "blocked" in form else \
        (lambda p, c: JSegmentedQuery(p, c, block_rows=1024, resident_rows=2048))
    want = _outcome(lambda: jax_form(STREAM_PLANS[plan](jcat, False), jcat).run(),
                    JPlanNotCompilable)
    got = _outcome(lambda: PORT_STREAMED[form](STREAM_PLANS[plan](cat, True), cat).run(),
                   PlanNotCompilable)
    if want[0] == "refused":
        assert got[0] == "refused" and "IndexScan" in got[1], got
        assert "IndexScan" in want[1]
    else:
        assert got[0] != "refused", got
        (s, c), = got
        (js, jc), = want
        assert c == jc and abs(s - js) <= 1e-9 * max(abs(js), 1.0)
    compiled = _outcome(lambda: CompiledQuery(STREAM_PLANS[plan](cat, True), cat).run(),
                        PlanNotCompilable)
    assert compiled[0] != "refused"


@pytest.mark.parametrize("mode", ["INNER", "LEFT", "RIGHT", "SEMI", "ANTI"])
def test_join_index_compiled_sorts_as_the_jax_compiled_query(mode, monkeypatch):
    cat, jcat = _stream_tables()
    plan = JoinIndex(IndexScan(GetTable("fact", cat), "a", P.LESS_THAN, 50),
                     GetTable("dim", cat), JoinMode[mode], ("k", "k"))
    jplan = JJoinIndex(JIndexScan(jax_ops.GetTable("fact", jcat), "a", JCond.LESS_THAN, 50),
                       jax_ops.GetTable("dim", jcat), JJoinMode[mode], ("k", "k"))
    cq = _both(plan, jplan, cat, jcat)
    assert plan.performance_data.extra.get("index_used") is False
    # the JAX RIGHT join records it on its swapped inner operator
    assert not jplan.performance_data.extra.get("index_used")
    with monkeypatch.context() as m:
        _no_index_lookups(m)
        cq.run()
    # eagerly the index serves (RIGHT builds on fact, which has none on k),
    # rows as Join's
    eager = JoinIndex(GetTable("fact", cat), GetTable("dim", cat), JoinMode[mode], ("k", "k"))
    out = execute_plan(eager).rows()
    assert eager.performance_data.extra.get("index_used") is (mode != "RIGHT")
    assert out == execute_plan(Join(GetTable("fact", cat), GetTable("dim", cat),
                                    JoinMode[mode], ("k", "k"))).rows()

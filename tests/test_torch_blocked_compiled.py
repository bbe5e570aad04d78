"""The compiled blocked form of the port (hyrise_tpu_torch/plan/blocked.py
BlockedCompiledQuery) against the JAX package's BlockedCompiledQuery and the
port's eager BlockedQuery, on the CPU.

The same numpy-seeded TPC-H at SF 0.02 goes through both packages with
tests/test_blocked.py's block size (a quarter of the JAX lineitem's
capacity, which leaves the port's last block partial): ints and strings
exactly, floats within 1e-6 relative, in order. On CPU tensors every block
runs the capacity mode uncaptured, so the window, the per-block partial
buffers, the one read of the stacked counts, the retries and the tightening
are the code the card runs. Also: tests/test_blocked.py's refusals in both
packages and its accepted shapes against the JAX form, ROADMAP C1's
UnionAll on the stream path (refused by the port), and what the JAX form
cannot show: a partial last block, an empty stream table, a later block
denser than block 0 (an overflow retry), a replaced stream table, a table
of no positions as a capacity-mode source, and MVCC tables refused. The JAX
results are computed once per module."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.expression import ast as jax_ast
from hyrise_tpu.ops.aggregate import Aggregate as JaxAggregate
from hyrise_tpu.ops.get_table import GetTable as JaxGetTable
from hyrise_tpu.ops.join import Join as JaxJoin
from hyrise_tpu.ops.misc import Limit as JaxLimit
from hyrise_tpu.ops.sort import Sort as JaxSort
from hyrise_tpu.ops.table_scan import TableScan as JaxTableScan
from hyrise_tpu.plan.blocked import BlockedCompiledQuery as JaxBlockedCompiledQuery
from hyrise_tpu.plan.compiler import PlanNotCompilable as JaxPlanNotCompilable
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.types import JoinMode as JaxJoinMode
from hyrise_tpu.types import SortMode as JaxSortMode
from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.misc import Limit, UnionAll
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.plan.blocked import BlockedCompiledQuery, BlockedQuery, PlanNotCompilable
from hyrise_tpu_torch.plan.compiler import CompiledQuery
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query
from hyrise_tpu_torch.types import DataType, JoinMode, SortMode
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

SF = 0.02
QIDS = (1, 3, 6, 14)
_state = {}


def _catalogs():
    if not _state:
        jcat = JaxCatalog()
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        cat = Catalog(device="cpu")
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        _state.update(jcat=jcat, cat=cat)
    return _state["jcat"], _state["cat"]


@pytest.fixture(scope="module")
def jax_blocked():
    """tests/test_blocked.py's block size and the JAX BlockedCompiledQuery's
    rows of each of QIDS (one run each)."""
    jcat, _ = _catalogs()
    block = max(jcat.get_table("lineitem").capacity // 4, 1 << 14)
    rows = {qid: JaxBlockedCompiledQuery(JAX_PLANS[qid](jcat), jcat, block_rows=block)
            .run().rows() for qid in QIDS}
    return block, rows


def _port_table(name, df) -> Table:
    defs, arrays = [], []
    for c in df.columns:
        arr = df[c].to_numpy()
        dt = {np.dtype(np.int64): DataType.INT64, np.dtype(np.float64): DataType.FLOAT64}[arr.dtype]
        defs.append(TableColumnDefinition(c, dt))
        arrays.append(arr)
    return Table.from_arrays(name, defs, arrays, device="cpu")


def _both(**frames):
    """The same pandas frames as a JAX catalog and a port catalog."""
    jcat, cat = JaxCatalog(), Catalog(device="cpu")
    for name, df in frames.items():
        jcat.add_table(name, JaxTable.from_pandas(name, df))
        cat.add_table(name, _port_table(name, df))
    return jcat, cat


def _walk(root, seen=None):
    seen = set() if seen is None else seen
    if id(root) in seen:
        return []
    seen.add(id(root))
    out = [root]
    for i in root.inputs:
        out += _walk(i, seen)
    return out


# -- TPC-H against the JAX compiled form and the port's eager form -------------


@pytest.mark.parametrize("qid", QIDS)
def test_blocked_compiled_matches_jax(qid, jax_blocked):
    block, want = jax_blocked
    _, cat = _catalogs()
    rows = cat.get_table("lineitem").num_rows
    assert rows % block  # the port's last block is partial
    bq = BlockedCompiledQuery(TPCH_PLANS[qid](cat), cat, block_rows=block)
    assert bq.n_blocks == -(-rows // block) >= 2
    assert_tables_equal(bq.run().rows(), want[qid], ordered=True, rel_tol=1e-6)
    eager_bq = BlockedQuery(TPCH_PLANS[qid](cat), cat, block_rows=block)
    assert_tables_equal(eager_bq.run().rows(), want[qid], ordered=True, rel_tol=1e-6)
    reads = compiler.eager_reads()
    assert_tables_equal(bq.run().rows(), want[qid], ordered=True, rel_tol=1e-6)
    assert bq.last_retries == 0
    assert bq.host_reads == 2  # the stacked block counts and the merge's
    assert compiler.eager_reads() == reads
    # the eager form builds each shared build side once a run, the block
    # program once a block
    assert eager_bq.builds == {1: 0, 3: 1, 6: 0, 14: 1}[qid]
    assert bq.builds == bq.n_blocks * eager_bq.builds
    assert_tables_equal(run_query(qid, cat, via="compiled-blocked", block_rows=block).rows(),
                        want[qid], ordered=True, rel_tol=1e-6)


def test_blocked_compiled_kept_on_the_catalog():
    _, cat = _catalogs()
    run_query(6, cat, via="compiled-blocked", block_rows=1 << 15)
    q = cat.compiled[("compiled-blocked", 6, 1 << 15, 1 << 24)]
    assert isinstance(q, BlockedCompiledQuery)
    run_query(6, cat, via="compiled-blocked", block_rows=1 << 15)
    assert cat.compiled[("compiled-blocked", 6, 1 << 15, 1 << 24)] is q
    with pytest.raises(PlanNotCompilable):  # refused: never the eager form
        run_query(18, cat, via="compiled-blocked", block_rows=1 << 15)
    del cat.compiled[("compiled-blocked", 6, 1 << 15, 1 << 24)]


def test_blocked_compiled_leaves_plan_intact():
    _, cat = _catalogs()
    plan = TPCH_PLANS[1](cat)
    before = [(id(op), [id(i) for i in op.inputs]) for op in _walk(plan)]
    out = BlockedCompiledQuery(plan, cat, block_rows=1 << 14).run()
    assert [(id(op), [id(i) for i in op.inputs]) for op in _walk(plan)] == before
    assert all(op.get_output() is None for op in _walk(plan))
    assert_tables_equal(out.rows(), execute_plan(plan).rows(), ordered=True, rel_tol=1e-6)


# -- refusals, in both packages ------------------------------------------------


def _nested_aggregate(pkg):
    ast_, agg, get, cat = pkg
    inner = agg(get("big", cat), ["g"], [("s", ast_.sum_(ast_.col("v")))])
    return agg(inner, [], [("m", ast_.max_(ast_.col("s")))])


REFUSED = {
    "self_join": (18, "lineitem", "referenced 2 times"),
    "no_aggregate": (2, None, "top-level Aggregate"),
    "semi_build_stream": (4, None, "not row-distributive"),
    "left_build_nested_agg": (13, None, "not row-distributive"),
    "anti_build_stream": (22, None, "not row-distributive"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_blocked_compiled_refuses_tpch_shapes(case):
    qid, stream, match = REFUSED[case]
    jcat, cat = _catalogs()
    with pytest.raises(JaxPlanNotCompilable, match=match):
        JaxBlockedCompiledQuery(JAX_PLANS[qid](jcat), jcat, stream_table=stream,
                                block_rows=1 << 14)
    with pytest.raises(PlanNotCompilable, match=match):
        BlockedCompiledQuery(TPCH_PLANS[qid](cat), cat, stream_table=stream, block_rows=1 << 14)


def test_blocked_compiled_refuses_nested_aggregate_on_path():
    rng = np.random.default_rng(3)
    n = 4096
    df = pd.DataFrame({"g": rng.integers(0, 7, n).astype(np.int64),
                       "v": rng.random(n).astype(np.float64)})
    jcat, cat = _both(big=df)
    with pytest.raises(JaxPlanNotCompilable, match="not row-distributive"):
        JaxBlockedCompiledQuery(_nested_aggregate((jax_ast, JaxAggregate, JaxGetTable, jcat)),
                                jcat, block_rows=1024)
    with pytest.raises(PlanNotCompilable, match="not row-distributive"):
        BlockedCompiledQuery(_nested_aggregate((ast, Aggregate, GetTable, cat)), cat,
                             block_rows=1024)


def test_blocked_compiled_refuses_union_on_stream_path():
    """ROADMAP C1: the JAX form accepts a UnionAll on the stream path and
    counts its other input once per block; the port refuses it."""
    _, cat = _catalogs()
    two = _port_table("two", pd.DataFrame({"l_quantity": np.ones(2)}))
    union = UnionAll(Projection(GetTable("lineitem", cat), ["l_quantity"]), TableWrapper(two))
    with pytest.raises(PlanNotCompilable, match="UnionAll on the stream path"):
        BlockedCompiledQuery(Aggregate(union, [], [("n", ast.count_())]), cat,
                             block_rows=1 << 14)


@pytest.mark.parametrize("table", ["big", "dim"])
def test_blocked_compiled_refuses_mvcc_tables(table):
    """An MVCC table, streamed or not, is refused when the query is made."""
    big = pd.DataFrame({"k": np.arange(100, dtype=np.int64) % 7, "v": np.ones(100)})
    dim = pd.DataFrame({"dk": np.arange(7, dtype=np.int64)})
    _, cat = _both(big=big, dim=dim)
    t = cat.get_table(table)
    t.mvcc = MvccData.for_new_table(t.num_rows, t.num_rows, device="cpu")
    joined = Join(GetTable("big", cat), GetTable("dim", cat), JoinMode.INNER, ("k", "dk"))
    plan = Aggregate(joined, ["dk"], [("s", ast.sum_(ast.col("v")))])
    with pytest.raises(PlanNotCompilable, match="MVCC table " + table):
        BlockedCompiledQuery(plan, cat, block_rows=32)


# -- accepted shapes of tests/test_blocked.py, against the JAX form ------------


def _avg_plan(pkg):
    ast_, agg, get, cat = pkg
    return agg(get("t", cat), ["g"], [("a", ast_.avg_(ast_.col("v"))),
                                      ("q", ast_.avg_(ast_.col("g")))])


def _topk_plan(pkg, limit, sort, scan, desc):
    ast_, _, get, cat = pkg
    return limit(sort(scan(get("t", cat), ast_.col("a") < ast_.lit(500)),
                      [("v", desc), "a"]), 25)


def _semi_plan(pkg, join, semi, sort):
    ast_, agg, get, cat = pkg
    joined = join(get("big", cat), get("dim", cat), semi, ("k", "dk"))
    return sort(agg(joined, ["g"], [("s", ast_.sum_(ast_.col("v"))), ("n", ast_.count_())]),
                ["g"])


def _having_plan(pkg, scan, sort):
    ast_, agg, get, cat = pkg
    summed = agg(get("t", cat), ["g"], [("s", ast_.sum_(ast_.col("v")))])
    return sort(scan(summed, ast_.col("s") > ast_.lit(40.0)), ["g"])


def _accepted(case):
    """(JAX catalog, port catalog, JAX plan, port plan, block rows, sort
    the rows first?)"""
    rng = np.random.default_rng({"avg": 1, "topk": 4, "semi": 11, "having": 9}[case])
    if case == "avg":
        df = pd.DataFrame({"g": np.repeat(np.arange(4, dtype=np.int64), 4),
                           "v": np.arange(16, dtype=np.int64).astype(np.float64)})
        df["v"] = df["v"].astype(np.int64)
        jcat, cat = _both(t=df)
        return (jcat, cat, _avg_plan((jax_ast, JaxAggregate, JaxGetTable, jcat)),
                _avg_plan((ast, Aggregate, GetTable, cat)), 8, True)
    if case == "topk":
        n = 5000
        df = pd.DataFrame({"a": rng.integers(0, 1000, n).astype(np.int64),
                           "v": rng.normal(size=n).astype(np.float64)})
        jcat, cat = _both(t=df)
        return (jcat, cat,
                _topk_plan((jax_ast, None, JaxGetTable, jcat), JaxLimit, JaxSort,
                           JaxTableScan, JaxSortMode.DESCENDING),
                _topk_plan((ast, None, GetTable, cat), Limit, Sort, TableScan,
                           SortMode.DESCENDING), 2048, False)
    if case == "semi":
        n = 4096
        big = pd.DataFrame({"k": rng.integers(0, 200, n).astype(np.int64),
                            "g": rng.integers(0, 5, n).astype(np.int64),
                            "v": rng.random(n).astype(np.float64)})
        dim = pd.DataFrame({"dk": np.arange(0, 200, 3, dtype=np.int64)})
        jcat, cat = _both(big=big, dim=dim)
        return (jcat, cat,
                _semi_plan((jax_ast, JaxAggregate, JaxGetTable, jcat), JaxJoin,
                           JaxJoinMode.SEMI, JaxSort),
                _semi_plan((ast, Aggregate, GetTable, cat), Join, JoinMode.SEMI, Sort),
                1024, False)
    n = 4000
    df = pd.DataFrame({"g": rng.integers(0, 50, n).astype(np.int64),
                       "v": rng.random(n).astype(np.float64)})
    jcat, cat = _both(t=df)
    return (jcat, cat, _having_plan((jax_ast, JaxAggregate, JaxGetTable, jcat), JaxTableScan,
                                    JaxSort),
            _having_plan((ast, Aggregate, GetTable, cat), TableScan, Sort), 1024, False)


@pytest.mark.parametrize("case", ["avg", "topk", "semi", "having"])
def test_blocked_compiled_accepted_shapes_match_jax(case):
    jcat, cat, jplan, plan, block, unordered = _accepted(case)
    jq = JaxBlockedCompiledQuery(jplan, jcat, block_rows=block)
    want = jq.run().rows()
    bq = BlockedCompiledQuery(plan, cat, block_rows=block)
    assert bq.n_blocks == jq.n_blocks >= 2
    assert bq._mode == jq._mode == ("topk" if case == "topk" else "agg")
    for _ in range(2):
        got = bq.run().rows()
        if unordered:
            got, want = sorted(got), sorted(want)
        assert_tables_equal(got, want, ordered=True, rel_tol=1e-9)
    assert bq.last_retries == 0
    if case == "avg":
        assert [r[1] for r in sorted(got)] == [1.5, 5.5, 9.5, 13.5]


# -- shapes the JAX form cannot show --------------------------------------------


def _grouped(cat, name="t"):
    return Aggregate(TableScan(GetTable(name, cat), ast.col("v") > ast.lit(0.25)), ["g"],
                     [("s", ast.sum_(ast.col("v"))), ("n", ast.count_()),
                      ("lo", ast.min_(ast.col("v")))])


@pytest.mark.parametrize("rows", [0, 1, 1000, 1024, 1025, 3 * 1024 + 7])
def test_blocked_compiled_block_edges(rows):
    """An empty stream table (one empty block), one row, a table inside one
    block, exactly one block, and partial last blocks; against the eager
    plan and the eager blocked form."""
    rng = np.random.default_rng(rows)
    df = pd.DataFrame({"g": rng.integers(0, 9, rows).astype(np.int64),
                       "v": rng.random(rows).astype(np.float64)})
    _, cat = _both(t=df)
    want = sorted(execute_plan(_grouped(cat)).rows())
    bq = BlockedCompiledQuery(_grouped(cat), cat, block_rows=1024)
    assert bq.n_blocks == max(-(-rows // 1024), 1)
    assert bq.block_rows == max(min(rows, 1024), 1)
    for _ in range(2):
        assert_tables_equal(sorted(bq.run().rows()), want, ordered=True, rel_tol=1e-9)
    eager = BlockedQuery(_grouped(cat), cat, block_rows=1024).run().rows()
    assert_tables_equal(sorted(eager), want, ordered=True, rel_tol=1e-9)
    total = BlockedCompiledQuery(Aggregate(GetTable("t", cat), [], [("n", ast.count_())]), cat,
                                 block_rows=1024)
    assert total.run().rows() == [(rows,)]


def _dense_later(block):
    """A stream table whose third block joins 50 dimension rows a row where
    block 0's rows join one: the join's expansion, sized by block 0, must
    overflow in block 2."""
    keys = np.concatenate([np.arange(block) % 10, np.arange(block) % 10,
                           np.full(block, 100), np.arange(block // 2) % 10]).astype(np.int64)
    big = pd.DataFrame({"k": keys, "v": np.arange(len(keys), dtype=np.float64)})
    dim = pd.DataFrame({"dk": np.concatenate([np.arange(10), np.full(50, 100)]).astype(np.int64),
                        "w": np.arange(60, dtype=np.float64)})
    return _both(big=big, dim=dim)


def _dense_plan(cat):
    joined = Join(GetTable("big", cat), GetTable("dim", cat), JoinMode.INNER, ("k", "dk"))
    return Sort(Aggregate(joined, ["dk"], [("s", ast.sum_(ast.col("v") + ast.col("w"))),
                                           ("n", ast.count_())]), ["dk"])


def test_blocked_compiled_dense_later_block_retries():
    block = 1024
    _, cat = _dense_later(block)
    want = execute_plan(_dense_plan(cat)).rows()
    bq = BlockedCompiledQuery(_dense_plan(cat), cat, block_rows=block)
    assert bq.n_blocks == 4
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)
    assert bq.last_retries >= 1  # block 2 overflowed what block 0 taught
    caps = list(bq.caps)
    assert max(caps) >= 50 * block
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)
    assert bq.last_retries == 0 and bq.caps == caps  # the across-block maximum held
    eager = BlockedQuery(_dense_plan(cat), cat, block_rows=block).run().rows()
    assert_tables_equal(eager, want, ordered=True, rel_tol=1e-9)


def test_blocked_compiled_replaced_stream_table():
    """A stream table replaced in the catalog gets a window of its own: the
    next run streams the new table's blocks."""
    _, cat = _catalogs()
    half_cat = Catalog(device="cpu")
    for name in cat.table_names():
        half_cat.add_table(name, cat.get_table(name))
    bq = BlockedCompiledQuery(TPCH_PLANS[6](half_cat), half_cat, block_rows=1 << 14)
    bq.run()
    window = bq._window
    li = half_cat.get_table("lineitem")
    half_cat.replace_table("lineitem", li.block(0, li.num_rows // 2))
    want = execute_plan(TPCH_PLANS[6](half_cat)).rows()
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)
    assert bq._window is not window and bq.n_blocks == -(-(li.num_rows // 2) // (1 << 14))


@pytest.mark.parametrize("grouped", [True, False])
def test_capacity_mode_over_a_table_of_no_positions(grouped):
    """ROADMAP C27: a capacity-mode source of no positions reads as one dead
    row (ops/get_table.py); a group-by over it indexed past its end."""
    df = pd.DataFrame({"g": np.zeros(0, np.int64), "v": np.zeros(0)})
    _, cat = _both(t=df)
    plan = Aggregate(GetTable("t", cat), ["g"] if grouped else [],
                     [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])
    want = execute_plan(plan).rows()
    for op in _walk(plan):
        op.clear_output()
    assert CompiledQuery(plan, cat).run().rows() == want == ([] if grouped else [(None, 0)])

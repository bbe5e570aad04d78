"""Block statistics and scan pruning: hyrise_tpu_torch.storage.block_statistics
against hyrise_tpu.storage.block_statistics on the same exported tables, on
CPU tensors, with blocks of 64 rows.

- Bounds equal the JAX package's wherever its float64 bounds are exact, and keep_mask equals its mask over a sweep of conditions,
  literals (present, absent, below the minimum, above the maximum) and
  column types, both sides of the comparison and BETWEEN.
- TableScan prunes every block only when no block can match, and its empty
  result is a valid empty table, from a masked table too
  (tests/test_storage_extras.py's pruning cases).
- ROADMAP C13 (INT64 above 2^53, which float64 bounds round) and C14 (a NaN
  in a FLOAT64 block, which spoils numpy's min and max): the scan with
  statistics gives the rows of the scan without, and sqlite's.
- C16's rule holds in pruning: a fractional or out-of-range literal on an
  integral column prunes as the scan compares.
- The statistics reach the scans of a SQL statement, through the Alias and
  the column-pruning Projection the translator puts over a stored table,
  under the names those give (the JAX package's SQL path never prunes)."""

import numpy as np
import pytest
import torch

from hyrise_tpu.expression import ast as jax_ast
from hyrise_tpu.storage.block_statistics import BlockStatistics as JaxBlockStatistics
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu.types import PredicateCondition as JaxCond
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops import TableWrapper, execute_plan
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.block_statistics import (BlockStatistics,
                                                       attach_block_statistics)
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import PredicateCondition
from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

BLOCK = 64
N = 3000
CONDS = ["EQUALS", "LESS_THAN", "LESS_THAN_EQUALS", "GREATER_THAN",
         "GREATER_THAN_EQUALS"]


def _port_table(jt: JaxTable) -> Table:
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return table_from_numpy(jt.name, cols, jt.num_rows, device="cpu")


def _sweep_table(seed: int = 2) -> JaxTable:
    """Clustered columns of every type, so blocks differ; NULLs in every
    column, and three whole blocks of NULLs in `i`."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.integers(0, 400, N))
    valid = rng.random(N) >= 0.05
    i_valid = valid.copy()
    i_valid[BLOCK * 5:BLOCK * 8] = False
    return JaxTable.from_arrays(
        "t", [JaxDef("i", JaxDataType.INT32, True), JaxDef("l", JaxDataType.INT64, True),
              JaxDef("f", JaxDataType.FLOAT32, True), JaxDef("d", JaxDataType.FLOAT64, True),
              JaxDef("s", JaxDataType.STRING, True)],
        [(base * 2).astype(np.int32), (base * 7 - 900).astype(np.int64),
         (base / 8).astype(np.float32), base / 4 - 20.0,
         np.array([f"k{v:03d}" for v in base], dtype=object)],
        [i_valid, valid, valid, valid, valid])


@pytest.fixture(scope="module")
def sweep():
    jt = _sweep_table()
    t = _port_table(jt)
    return jt, t, JaxBlockStatistics.generate(jt, BLOCK), BlockStatistics.generate(t, BLOCK)


@pytest.mark.parametrize("column", ["i", "l", "f", "d", "s"])
def test_bounds_equal_jax(sweep, column):
    jt, t, jst, st = sweep
    assert st.n_blocks == jst.n_blocks and st.block_rows == jst.block_rows
    want, got = jst.columns[column], st.columns[column]
    assert got.mins.dtype == t.column(column).data.numpy().dtype
    np.testing.assert_array_equal(got.empty, np.isinf(want.mins))
    full = ~got.empty
    np.testing.assert_array_equal(got.mins[full].astype(np.float64), want.mins[full])
    np.testing.assert_array_equal(got.maxs[full].astype(np.float64), want.maxs[full])
    if column == "i":
        assert got.empty.sum() == 3


def _literals(column: str, values: np.ndarray):
    """A present value, an absent one inside the range, and one below the
    minimum and one above the maximum, of the column's kind (floats exact
    in float32, so the JAX package's float64 comparison is exact too)."""
    if column == "s":
        present = sorted(set(values))
        return [present[len(present) // 2], "k1995", "a", "z"]
    lo, hi = values.min(), values.max()
    mid = values[len(values) // 2]
    if column in ("i", "l"):
        absent = next(v for v in range(int(mid), int(hi)) if v not in set(values.tolist()))
        return [int(mid), absent, int(lo) - 1, int(hi) + 1]
    return [float(mid), float(mid) + 1 / 16, float(lo) - 1.0, float(hi) + 0.5]


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("column", ["i", "l", "f", "d", "s"])
def test_keep_mask_equals_jax(sweep, column, cond):
    jt, t, jst, st = sweep
    values = t.column(column).decode(t.num_rows)
    present = values[t.column(column).validity.numpy()[:t.num_rows]]
    for v in _literals(column, present):
        for flip in (False, True):
            c, jc = PredicateCondition[cond], JaxCond[cond]
            args = (ast.lit(v), ast.col(column)) if flip else (ast.col(column), ast.lit(v))
            jargs = (jax_ast.lit(v), jax_ast.col(column)) if flip else \
                (jax_ast.col(column), jax_ast.lit(v))
            got = st.keep_mask(t, ast.Comparison(c.flipped() if flip else c, *args))
            want = jst.keep_mask(jt, jax_ast.Comparison(jc.flipped() if flip else jc, *jargs))
            np.testing.assert_array_equal(got, want, err_msg=f"{column} {cond} {v!r}")
            # pruning keeps every block that holds a match
            matched = execute_plan(TableScan(TableWrapper(t), ast.Comparison(
                c.flipped() if flip else c, *args)))
            assert matched.num_rows == 0 or got.any()


@pytest.mark.parametrize("column", ["i", "l", "d", "s"])
def test_keep_mask_of_between_and_conjunctions_equals_jax(sweep, column):
    jt, t, jst, st = sweep
    values = t.column(column).decode(t.num_rows)
    lits = _literals(column, values[t.column(column).validity.numpy()[:t.num_rows]])
    for lo, hi in [(lits[0], lits[1]), (lits[2], lits[0]), (lits[1], lits[3]),
                   (lits[3], lits[2])]:
        got = st.keep_mask(t, ast.col(column).between(lo, hi))
        want = jst.keep_mask(jt, jax_ast.col(column).between(lo, hi))
        np.testing.assert_array_equal(got, want)
    got = st.keep_mask(t, (ast.col(column) >= ast.lit(lits[0])) & (ast.col("l") < ast.lit(0)))
    want = jst.keep_mask(jt, (jax_ast.col(column) >= jax_ast.lit(lits[0]))
                         & (jax_ast.col("l") < jax_ast.lit(0)))
    np.testing.assert_array_equal(got, want)
    # what statistics cannot judge keeps every block
    assert st.keep_mask(t, ast.col(column) != ast.lit(lits[0])) is None
    assert st.keep_mask(t, ast.col("i") < ast.col("l")) is None


# -- TableScan's pruning (tests/test_storage_extras.py) ---------------------------


def _clustered(n: int = 1000) -> Table:
    rng = np.random.default_rng(1)
    return table_from_numpy("t", [
        ("a", "int32", np.arange(n, dtype=np.int32), None, None),
        ("b", "int32", rng.integers(0, 100, n).astype(np.int32), None, None)],
        n, device="cpu")


def test_block_pruning_short_circuit():
    t = _clustered()
    attach_block_statistics(t, block_rows=100)
    scan = TableScan(TableWrapper(t), ast.col("a") > ast.lit(10**6))
    out = execute_plan(scan)
    assert out.num_rows == 0 and out.column_names == ["a", "b"]
    assert out.rows() == [] and out.column("a").data.shape[0] == 0
    assert scan.performance_data.extra.get("pruned_all_blocks") is True


def test_block_pruning_keeps_correctness():
    t = _clustered()
    attach_block_statistics(t, block_rows=100)
    scan = TableScan(TableWrapper(t), ast.col("a").between(150, 250))
    assert execute_plan(scan).num_rows == 101
    assert "pruned_all_blocks" not in scan.performance_data.extra


def test_block_pruning_of_a_masked_table():
    t = _clustered()
    live = torch.arange(t.capacity) % 2 == 0
    masked = Table(t.columns, int(live.sum()), name="t", live=live)
    st = attach_block_statistics(masked, block_rows=100)
    assert st.n_blocks == 10
    # the largest live value is 998: > 998 prunes every block, >= 998 none
    scan = TableScan(TableWrapper(masked), ast.col("a") > ast.lit(998))
    out = execute_plan(scan)
    assert scan.performance_data.extra.get("pruned_all_blocks") is True
    assert out.num_rows == 0 and out.is_prefix and out.rows() == []
    out = execute_plan(TableScan(TableWrapper(masked), ast.col("a") >= ast.lit(998)))
    assert out.rows() == [(998, t.column("b").data[998].item())]


def test_statistics_ignore_dead_rows_past_num_rows():
    t = table_from_numpy("t", [("a", "int64", np.array([1, 2, 3, 10**9]), None, None)], 3,
                         device="cpu")  # the last row is headroom
    st = BlockStatistics.generate(t, 2)
    assert st.n_blocks == 2 and st.columns["a"].maxs.tolist() == [2, 3]


# -- C13, C14 and C16 against the scan without statistics and sqlite --------------


def _scan_with_and_without(t: Table, pred, sql: str):
    plain = execute_plan(TableScan(TableWrapper(t), pred)).rows()
    attach_block_statistics(t, BLOCK)
    pruned = execute_plan(TableScan(TableWrapper(t), pred)).rows()
    t.block_stats = None
    want = SqliteOracle({"t": t}).query(sql)
    assert_tables_equal(pruned, plain, ordered=True, rel_tol=0, abs_tol=0)
    assert_tables_equal(pruned, want, ordered=False, rel_tol=0, abs_tol=0)
    return pruned


def test_c13_int64_above_2_53_is_not_rounded():
    """One row of 2^53 + 3: `a < 2^53 + 4` holds. In float64 both round to
    2^53 + 4, and the JAX package's bounds prune the row."""
    v = 2**53 + 3
    t = table_from_numpy("t", [("a", "int64", np.array([v]), None, None)], 1, device="cpu")
    rows = _scan_with_and_without(t, ast.col("a") < ast.lit(v + 1),
                                  f"SELECT a FROM t WHERE a < {v + 1}")
    assert rows == [(v,)]
    st = BlockStatistics.generate(t, BLOCK)
    assert st.columns["a"].mins.tolist() == [v] and st.columns["a"].maxs.tolist() == [v]
    # the JAX package's bounds are float64 and prune the row away
    jt = JaxTable.from_arrays("t", [JaxDef("a", JaxDataType.INT64)], [np.array([v])])
    jkeep = JaxBlockStatistics.generate(jt, BLOCK).keep_mask(
        jt, jax_ast.col("a") < jax_ast.lit(v + 1))
    assert not jkeep.any()
    assert st.keep_mask(t, ast.col("a") < ast.lit(v + 1)).all()
    assert not st.keep_mask(t, ast.col("a") > ast.lit(v)).any()


def test_c14_nan_neither_sets_nor_spoils_bounds():
    """[1.0, NaN] in one FLOAT64 block: `a = 1.0` returns its row. numpy's
    min and max of the block are NaN, and the JAX package prunes it."""
    t = table_from_numpy("t", [("a", "float64", np.array([1.0, np.nan]), None, None)], 2,
                         device="cpu")
    rows = _scan_with_and_without(t, ast.col("a") == ast.lit(1.0),
                                  "SELECT a FROM t WHERE a = 1.0")
    assert rows == [(1.0,)]
    st = BlockStatistics.generate(t, BLOCK).columns["a"]
    assert st.mins.tolist() == [1.0] and st.maxs.tolist() == [1.0] and not st.empty[0]
    jt = JaxTable.from_arrays("t", [JaxDef("a", JaxDataType.FLOAT64)],
                              [np.array([1.0, np.nan])])
    jst = JaxBlockStatistics.generate(jt, BLOCK)
    assert not jst.keep_mask(jt, jax_ast.col("a") == jax_ast.lit(1.0)).any()
    # a block of NaNs only is empty: no comparison can match there
    t2 = table_from_numpy("t", [("a", "float32", np.array([np.nan] * 3), None, None)], 3,
                          device="cpu")
    rows = _scan_with_and_without(t2, ast.col("a") >= ast.lit(0.0),
                                  "SELECT a FROM t WHERE a >= 0.0")
    assert rows == []


@pytest.mark.parametrize("sql_cond,literal,expect", [
    ("<", 5.5, [1, 5]), ("<=", 5.5, [1, 5]), (">", 5.5, [9, 2**31 - 1]),
    (">=", 8.5, [9, 2**31 - 1]), ("=", 5.5, []), ("=", 5.0, [5]),
    ("<", 2**40, [1, 5, 9, 2**31 - 1]), (">", 2**40, []), (">", -(2**40), [1, 5, 9, 2**31 - 1]),
    ("<", -(2**40), []),
])
def test_c16_rule_in_pruning(sql_cond, literal, expect):
    t = table_from_numpy("t", [("a", "int32", np.array([1, 5, 9, 2**31 - 1], dtype=np.int32),
                                None, None)], 4, device="cpu")
    cond = {"<": PredicateCondition.LESS_THAN, "<=": PredicateCondition.LESS_THAN_EQUALS,
            ">": PredicateCondition.GREATER_THAN, ">=": PredicateCondition.GREATER_THAN_EQUALS,
            "=": PredicateCondition.EQUALS}[sql_cond]
    rows = _scan_with_and_without(t, ast.Comparison(cond, ast.col("a"), ast.lit(literal)),
                                  f"SELECT a FROM t WHERE a {sql_cond} {literal!r}")
    assert [r[0] for r in rows] == expect
    keep = BlockStatistics.generate(t, 2).keep_mask(
        t, ast.Comparison(cond, ast.col("a"), ast.lit(literal)))
    assert keep.tolist() == [bool(set(expect) & {1, 5}), bool(set(expect) & {9, 2**31 - 1})]


def test_statistics_through_sql_change_no_result():
    jt = _sweep_table(seed=4)
    t = _port_table(jt)
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    sql = ("SELECT s, COUNT(*), SUM(l) FROM t WHERE i BETWEEN 50 AND 250 AND d < 40.0 "
           "GROUP BY s ORDER BY s")
    want = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline().get_result_table().rows()
    attach_block_statistics(t, BLOCK)
    got = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline().get_result_table().rows()
    assert got == want


def _operators(op, seen=None):
    seen = set() if seen is None else seen
    if id(op) not in seen:
        seen.add(id(op))
        yield op
        for i in op.inputs:
            yield from _operators(i, seen)


def _sql_scans(sql: str, cat: Catalog):
    """The statement's rows and its TableScans' pruning flags."""
    pipeline = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans() \
        .create_pipeline()
    rows = pipeline.get_result_table().rows()
    plan = pipeline.pipeline_statements[-1].last_plan
    return rows, [op.performance_data.extra.get("pruned_all_blocks", False)
                  for op in _operators(plan) if isinstance(op, TableScan)]


@pytest.mark.parametrize("sql,pruned", [
    ("SELECT l FROM t WHERE i > 900", True),
    ("SELECT t.l, t.s FROM t WHERE t.i > 900 AND t.d < 0.0", True),
    ("SELECT x.l FROM t AS x WHERE x.s > 'k999'", True),
    ("SELECT s FROM t WHERE l < -901 ORDER BY s", True),
    ("SELECT l FROM t WHERE i BETWEEN 801 AND 2000", True),
    ("SELECT l FROM (SELECT l, i + 1 AS i FROM t) AS v WHERE i > 900", False),
    ("SELECT l FROM t WHERE i > 700", False),
    ("SELECT l FROM t WHERE i * 2 > 2000", False),
])
def test_sql_scans_read_the_statistics(sql, pruned):
    """A SQL scan of a stored table prunes every block exactly when no block
    can match; a column the statement computes has no statistics, however it
    is named. The rows equal sqlite's and those without statistics."""
    t = _port_table(_sweep_table(seed=4))
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    want, _ = _sql_scans(sql, cat)
    attach_block_statistics(t, BLOCK)
    got, flags = _sql_scans(sql, cat)
    assert flags and any(flags) is pruned
    assert_tables_equal(got, want, ordered=False, rel_tol=0, abs_tol=0)
    assert_tables_equal(got, SqliteOracle({"t": t}).query(sql), ordered=False,
                        rel_tol=1e-9, abs_tol=0)


def test_renamed_statistics_follow_the_first_column_of_a_name():
    """Where an output name repeats, Table.column resolves it to its first
    column, and so do the statistics: a computed column that shadows a
    forwarded one prunes nothing, and a forwarded one that comes first
    prunes as the stored column does."""
    from hyrise_tpu_torch.ops.misc import Alias
    from hyrise_tpu_torch.ops.projection import Projection
    t = _clustered()
    attach_block_statistics(t, BLOCK)
    pred = ast.col("b") > ast.lit(10**6)  # no stored value of a is above it
    shifted = ("b", ast.col("a") + ast.lit(10**7))
    for outputs, pruned in (([shifted, ("b", ast.col("a"))], False),
                            ([("b", ast.col("a")), shifted], True)):
        scan = TableScan(Projection(TableWrapper(t), outputs), pred)
        out = execute_plan(scan)
        assert scan.performance_data.extra.get("pruned_all_blocks", False) is pruned
        assert out.num_rows == (0 if pruned else t.num_rows)
    pred = ast.col("b") > ast.lit(500)  # a's values reach 999, b's 99
    for sources, pruned in ((["a", "b"], False), (["b", "a"], True)):
        scan = TableScan(Alias(TableWrapper(t), ["b", "b"], sources), pred)
        out = execute_plan(scan)
        assert scan.performance_data.extra.get("pruned_all_blocks", False) is pruned
        assert out.num_rows == (0 if pruned else 499)

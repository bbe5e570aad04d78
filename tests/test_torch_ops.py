"""Operator parity: TableScan, Projection, Sort and Aggregate of the port
(hyrise_tpu_torch.ops) against the same JAX operators on the same exported
table. Integers and strings must match exactly, floats within 1e-9
relative, NULLs in the same cells, rows in the same order."""

import math

import numpy as np
import pytest
import torch

import hyrise_tpu.expression.ast as jax_ast
import hyrise_tpu.ops as jax_ops
import hyrise_tpu_torch.expression.ast as torch_ast
import hyrise_tpu_torch.ops as torch_ops
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu.types import SortMode as JaxSortMode
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import SortMode

torch.set_num_threads(1)

N = 200


def _jax_table(masked: bool = False) -> JaxTable:
    rng = np.random.default_rng(3)
    T = JaxDataType
    defs = [JaxDef("k", T.INT32), JaxDef("k2", T.INT64, True), JaxDef("v", T.INT32),
            JaxDef("f", T.FLOAT32, True), JaxDef("d", T.FLOAT64),
            JaxDef("s", T.STRING, True)]
    arrays = [rng.integers(0, 5, N).astype(np.int32),
              rng.integers(0, 3, N).astype(np.int64),
              rng.integers(-50, 50, N).astype(np.int32),
              rng.random(N).astype(np.float32),
              rng.random(N) * 1e3 - 500,
              np.array(rng.choice(["ab", "ba", "cab", "zz", None], N), dtype=object)]
    t = JaxTable.from_arrays("t", defs, arrays,
                             [None, rng.random(N) < 0.8, None, rng.random(N) < 0.9,
                              None, None])
    if masked:
        import jax.numpy as jnp
        live = np.zeros(t.capacity, dtype=bool)
        live[:N] = rng.random(N) < 0.6
        t = JaxTable(t.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    return t


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy("t", cols, jt.num_rows, live, device="cpu")


def _same(got, want) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, str):
        return got == want
    if isinstance(want, (float, np.floating)):
        g, w = float(got), float(want)
        if math.isnan(w):
            return math.isnan(g)
        return math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return int(got) == int(want)


def _assert_rows_equal(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        assert all(_same(a, b) for a, b in zip(g, w)), (i, g, w)


def _run_both(build, masked=False):
    """build(ops, ast, SortMode, input_op) -> plan, run over the JAX table
    and its port copy; returns (port rows, JAX rows, port output table)."""
    jt = _jax_table(masked)
    pt = _port_table(jt)
    jout = jax_ops.execute_plan(build(jax_ops, jax_ast, JaxSortMode,
                                      jax_ops.TableWrapper(jt)))
    pout = torch_ops.execute_plan(build(torch_ops, torch_ast, SortMode,
                                        torch_ops.TableWrapper(pt)))
    assert [c.name for c in pout.columns] == [c.name for c in jout.columns]
    assert [c.dtype.value for c in pout.columns] == [c.dtype.value for c in jout.columns]
    return pout.rows(), jout.rows(), pout


SCANS = {
    "int_gt": lambda A: A.col("v") > 0,
    "or_with_nulls": lambda A: (A.col("s") == "ba") | (A.col("f") < 0.5),
    "is_null": lambda A: A.col("k2").is_null(),
    "like": lambda A: A.col("s").like("%a%"),
    "between_float": lambda A: A.col("d").between(-100.0, 250.5),
    "empty": lambda A: A.col("v") > 1000,
}


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("name", sorted(SCANS))
def test_table_scan_matches_jax(name, masked):
    got, want, out = _run_both(
        lambda ops, A, S, src: ops.TableScan(src, SCANS[name](A)), masked)
    assert out.is_prefix
    _assert_rows_equal(got, want)


def test_projection_matches_jax():
    def build(ops, A, S, src):
        scan = ops.TableScan(src, A.col("v") != 0)
        return ops.Projection(scan, [
            "k", ("x", A.col("v") * 2 + A.col("k")), ("p", A.col("f") > 0.3),
            ("ss", A.col("s")), ("q", A.col("d") / A.col("v")),
            ("c", A.Case([(A.col("k") > 2, A.col("f"))], A.col("d")))])
    got, want, _ = _run_both(build)
    _assert_rows_equal(got, want)


SORTS = {
    "int_asc": [("v", "ASCENDING")],
    "two_keys_desc": [("k", "ASCENDING"), ("d", "DESCENDING")],
    "string_nulls_first": [("s", "ASCENDING"), ("v", "ASCENDING")],
    "string_nulls_last_desc": [("s", "ASCENDING_NULLS_LAST"), ("v", "DESCENDING")],
    "int64_desc_nulls_last": [("k2", "DESCENDING_NULLS_LAST"), ("f", "DESCENDING")],
    "float_nulls_first": [("f", "ASCENDING")],
    "string_desc_nulls_first": [("s", "DESCENDING"), ("k", "ASCENDING")],
}


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_matches_jax(name, masked):
    def build(ops, A, S, src):
        return ops.Sort(src, [(c, getattr(S, m)) for c, m in SORTS[name]])
    got, want, _ = _run_both(build, masked)
    _assert_rows_equal(got, want)


def _aggs(A):
    return [("sum_v", A.sum_(A.col("v"))), ("cnt", A.count_()),
            ("avg_f", A.avg_(A.col("f"))), ("min_d", A.min_(A.col("d"))),
            ("max_f", A.max_(A.col("f"))), ("cnt_f", A.count_(A.col("f"))),
            ("sum_f", A.sum_(A.col("f"))), ("min_k2", A.min_(A.col("k2"))),
            ("max_v", A.max_(A.col("v"))), ("min_s", A.min_(A.col("s"))),
            ("max_s", A.max_(A.col("s"))), ("sum_expr", A.sum_(A.col("d") * A.col("k")))]


AGGREGATES = {
    "global": ([], None),
    "by_string_with_null_group": (["s"], None),
    "by_two_keys_with_nulls": (["k", "k2"], None),
    "by_int": (["k"], None),
    "global_empty_input": ([], "empty"),
    "grouped_empty_input": (["k"], "empty"),
    "grouped_after_scan": (["s", "k"], "int_gt"),
}


@pytest.mark.parametrize("name", sorted(AGGREGATES))
def test_aggregate_matches_jax(name):
    groupby, scan = AGGREGATES[name]

    def build(ops, A, S, src):
        if scan is not None:
            src = ops.TableScan(src, SCANS[scan](A))
        return ops.Aggregate(src, groupby, _aggs(A))
    got, want, _ = _run_both(build)
    _assert_rows_equal(got, want)
    if name == "global_empty_input":
        assert got[0][1] == 0 and got[0][0] is None  # COUNT 0, SUM NULL
    if name == "grouped_empty_input":
        assert got == []


def test_grouped_aggregate_over_masked_input_matches_jax():
    def build(ops, A, S, src):
        return ops.Aggregate(src, ["s"], _aggs(A))
    got, want, _ = _run_both(build, masked=True)
    _assert_rows_equal(got, want)


def test_count_distinct_is_not_ported_yet():
    pt = _port_table(_jax_table())
    plan = torch_ops.Aggregate(torch_ops.TableWrapper(pt), [],
                               [("n", torch_ast.count_distinct(torch_ast.col("k")))])
    with pytest.raises(NotImplementedError):
        torch_ops.execute_plan(plan)


def test_global_aggregate_over_masked_input_matches_jax():
    # The port compacts a masked input itself; the JAX reference is given
    # the compacted rows through an always-true scan.
    jt = _jax_table(masked=True)
    pt = _port_table(jt)
    jplan = jax_ops.Aggregate(
        jax_ops.TableScan(jax_ops.TableWrapper(jt), jax_ast.col("v") == jax_ast.col("v")),
        [], _aggs(jax_ast))
    pplan = torch_ops.Aggregate(torch_ops.TableWrapper(pt), [], _aggs(torch_ast))
    got = torch_ops.execute_plan(pplan).rows()
    assert got[0][1] == jt.num_rows
    _assert_rows_equal(got, jax_ops.execute_plan(jplan).rows())

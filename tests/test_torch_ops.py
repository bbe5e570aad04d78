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
            JaxDef("s", T.STRING, True), JaxDef("g", T.STRING), JaxDef("h", T.STRING),
            JaxDef("w9", T.STRING), JaxDef("w8", T.STRING)]
    arrays = [rng.integers(0, 5, N).astype(np.int32),
              rng.integers(0, 3, N).astype(np.int64),
              rng.integers(-50, 50, N).astype(np.int32),
              rng.random(N).astype(np.float32),
              rng.random(N) * 1e3 - 500,
              np.array(rng.choice(["ab", "ba", "cab", "zz", None], N), dtype=object)]
    validities = [None, rng.random(N) < 0.8, None, rng.random(N) < 0.9, None, None]
    # NULL-free dictionary columns (drawn after the others, which keep their
    # values): g x h spans 6 cells, w9 x w8 spans 72
    for size in (3, 2, 9, 8):
        arrays.append(np.array([f"w{i}" for i in rng.integers(0, size, N)], dtype=object))
        validities.append(None)
    t = JaxTable.from_arrays("t", defs, arrays, validities)
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


def _count_distincts(A):
    return [("dk", A.count_distinct(A.col("k"))), ("dk2", A.count_distinct(A.col("k2"))),
            ("ds", A.count_distinct(A.col("s"))), ("df", A.count_distinct(A.col("f"))),
            ("dv", A.count_distinct(A.col("v") % 7)), ("cnt", A.count_())]


def test_count_distinct_is_not_ported_yet():
    """COUNT(DISTINCT) is ported (this test keeps the name it had while the
    port still refused it): the global form must match the JAX operator,
    NULLs not counted."""
    def build(ops, A, S, src):
        return ops.Aggregate(src, [], _count_distincts(A))
    got, want, _ = _run_both(build)
    _assert_rows_equal(got, want)
    assert got[0][0] == 5 and got[0][2] == 4  # k in 0..4; s has 4 words beside NULL


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("groupby", [["k"], ["s"], ["k", "k2"], ["g"]],
                         ids=["int", "string_with_nulls", "two_keys", "dense_key"])
def test_grouped_count_distinct_matches_jax(groupby, masked):
    def build(ops, A, S, src):
        return ops.Aggregate(src, groupby, _count_distincts(A))
    got, want, _ = _run_both(build, masked)
    _assert_rows_equal(got, want)


def test_global_count_distinct_of_no_rows_is_zero():
    def build(ops, A, S, src):
        return ops.Aggregate(ops.TableScan(src, SCANS["empty"](A)), [],
                             _count_distincts(A))
    got, want, _ = _run_both(build)
    _assert_rows_equal(got, want)
    assert got == [(0, 0, 0, 0, 0, 0)]


# -- the dense-cell form (global and low-cardinality group-bys) --------------------

DENSE = {
    "one_key": (["g"], None, False),
    "two_keys": (["g", "h"], None, False),
    "one_key_masked": (["g"], None, True),
    "two_keys_after_scan": (["h", "g"], "int_gt", False),
    "empty_input": (["g"], "empty", False),
    "masked_after_scan": (["g", "h"], "or_with_nulls", True),
}


@pytest.mark.parametrize("jax_form", ["0", "1"], ids=["jax_plain", "jax_fastpath"])
@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_aggregate_matches_jax(name, jax_form, monkeypatch):
    """The dense-cell form against the JAX operator in both of its
    formulations (its general branch, and its _fast_dense). JAX's plain
    global aggregate misreads a masked input, so masked cases group."""
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", jax_form)
    groupby, scan, masked = DENSE[name]
    calls = []
    import hyrise_tpu_torch.ops.aggregate as port_aggregate
    real = port_aggregate.segment_reduce_cells_many
    monkeypatch.setattr(port_aggregate, "segment_reduce_cells_many",
                        lambda cell, n, slots: calls.append(slots) or real(cell, n, slots))

    def build(ops, A, S, src):
        if scan is not None:
            src = ops.TableScan(src, SCANS[scan](A))
        return ops.Aggregate(src, groupby, _aggs(A))
    got, want, out = _run_both(build, masked)
    _assert_rows_equal(got, want)
    # one K3 call: the row count, and a slot for each of the 11 aggregates
    # that are not COUNT(*), over three nullable columns (f, k2, s)
    assert len(calls) == 1 and len(calls[0]) == 11
    assert sum(kind == "count" for _, _, kind in calls[0]) == 1
    assert len({id(v) for _, v, _ in calls[0] if v is not None}) == 3
    assert out.column(groupby[0]).unique == (len(groupby) == 1)


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
def test_global_aggregate_takes_the_dense_form(masked, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", "1")  # JAX's _fast_scalar reads the mask
    calls = []
    import hyrise_tpu_torch.ops.aggregate as port_aggregate
    real = port_aggregate.segment_reduce_cells_many
    monkeypatch.setattr(port_aggregate, "segment_reduce_cells_many",
                        lambda cell, n, slots: calls.append(n) or real(cell, n, slots))
    got, want, _ = _run_both(lambda ops, A, S, src: ops.Aggregate(src, [], _aggs(A)),
                             masked)
    _assert_rows_equal(got, want)
    assert calls == [1]  # one call, every reduction into one cell


def test_more_than_64_cells_takes_the_general_form(monkeypatch):
    import hyrise_tpu_torch.ops.aggregate as port_aggregate
    monkeypatch.setattr(port_aggregate, "segment_reduce_cells_many",
                        lambda *a, **k: pytest.fail("dense form over 72 cells"))
    got, want, _ = _run_both(
        lambda ops, A, S, src: ops.Aggregate(src, ["w9", "w8"], _aggs(A)))
    _assert_rows_equal(got, want)
    assert len(got) > 40


# -- operators over a lookup-join result (probe table under a live mask) -----------


def _dim_table() -> JaxTable:
    """A dimension with a unique key covering some of t.k's values."""
    T = JaxDataType
    t = JaxTable.from_arrays(
        "dim", [JaxDef("dk", T.INT32), JaxDef("dname", T.STRING), JaxDef("dw", T.FLOAT64)],
        [np.array([4, 0, 2], dtype=np.int32), np.array(["four", "zero", "two"], dtype=object),
         np.array([0.5, 1.5, 2.5])])
    t.column("dk").unique = True
    return t


OVER_LOOKUP_JOIN = {
    "global_aggregate": lambda ops, A, S, j: ops.Aggregate(j, [], _aggs(A) + [
        ("sum_dw", A.sum_(A.col("dw") * A.col("v")))]),
    "dense_group_by": lambda ops, A, S, j: ops.Aggregate(j, ["dname"], _aggs(A)),
    "general_group_by": lambda ops, A, S, j: ops.Aggregate(j, ["k2", "dname"], _aggs(A)),
    "sort": lambda ops, A, S, j: ops.Sort(j, [("dname", S.DESCENDING), ("v", S.ASCENDING)]),
    "scan_then_projection": lambda ops, A, S, j: ops.Projection(
        ops.TableScan(j, A.col("v") > 0), ["dname", ("x", A.col("dw") * A.col("d"))]),
    "limit": lambda ops, A, S, j: ops.Limit(j, 10),
}
# an existence join emits no build columns
OVER_EXISTENCE_JOIN = {
    "global_aggregate": lambda ops, A, S, j: ops.Aggregate(j, [], _aggs(A)),
    "dense_group_by": lambda ops, A, S, j: ops.Aggregate(j, ["g"], _aggs(A)),
    "general_group_by": lambda ops, A, S, j: ops.Aggregate(j, ["k2", "g"], _aggs(A)),
    "sort": lambda ops, A, S, j: ops.Sort(j, [("s", S.DESCENDING), ("v", S.ASCENDING)]),
    "limit": lambda ops, A, S, j: ops.Limit(j, 10),
}
OVER_JOIN_CASES = [(m, n) for m in ("INNER", "LEFT") for n in sorted(OVER_LOOKUP_JOIN)] \
    + [(m, n) for m in ("SEMI", "ANTI") for n in sorted(OVER_EXISTENCE_JOIN)]


@pytest.mark.parametrize("mode,name", OVER_JOIN_CASES)
def test_operator_over_a_lookup_join_result_matches_jax(name, mode, monkeypatch):
    """Every operator downstream must honour the live mask that the lookup
    join leaves on the untouched probe table. (The JAX package's plain
    global aggregate does not, so it runs in its mask-reading formulation.)"""
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", "1")
    from hyrise_tpu.types import JoinMode as JaxJoinMode
    from hyrise_tpu_torch.types import JoinMode
    consumer = (OVER_LOOKUP_JOIN if mode in ("INNER", "LEFT") else OVER_EXISTENCE_JOIN)[name]
    jt, jd = _jax_table(), _dim_table()
    pt, pd_ = _port_table(jt), _port_table(jd)
    pd_.column("dk").unique = True
    joins = []

    def plan(ops, A, S, modes, t, d):
        j = ops.Join(ops.TableWrapper(t), ops.TableWrapper(d), getattr(modes, mode),
                     ("k", "dk"))
        joins.append(j)
        return consumer(ops, A, S, j)
    jout = jax_ops.execute_plan(plan(jax_ops, jax_ast, JaxSortMode, JaxJoinMode, jt, jd))
    pout = torch_ops.execute_plan(plan(torch_ops, torch_ast, SortMode, JoinMode, pt, pd_))
    assert joins[1].path == "lut" and joins[1].get_output().live is not None
    assert pout.column_names == jout.column_names
    _assert_rows_equal(pout.rows(), jout.rows())


def test_nullable_key_before_another_key_groups_nulls_once(monkeypatch):
    """GROUP BY k2, g with NULLs in k2: all NULL rows of one g are ONE group,
    whatever values lie under the NULLs. The JAX package's plain form sorts
    by those hidden values first and splits the group (its sorted form does
    not), so the port is held to the sorted form and to a count by hand."""
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", "1")
    got, want, _ = _run_both(
        lambda ops, A, S, src: ops.Aggregate(src, ["k2", "g"], [("n", A.count_())]))
    _assert_rows_equal(got, want)
    assert len(got) == len({(r[0], r[1]) for r in got}) == 4 * 3
    assert sum(r[2] for r in got) == N


def test_second_join_over_a_lookup_join_result_matches_jax(monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", "1")
    from hyrise_tpu.types import JoinMode as JaxJoinMode
    from hyrise_tpu_torch.types import JoinMode
    jt, jd = _jax_table(), _dim_table()
    pt, pd_ = _port_table(jt), _port_table(jd)
    pd_.column("dk").unique = True

    def plan(ops, A, modes, t, d):
        j1 = ops.Join(ops.TableWrapper(t), ops.TableWrapper(d), modes.INNER, ("k", "dk"))
        # probe side again (lookup), then as the build side of a sorted join
        j2 = ops.Join(j1, ops.Alias(ops.TableWrapper(d), ["dk2", "dn2"], ["dk", "dname"]),
                      modes.LEFT, ("v", "dk2"))
        j3 = ops.Join(ops.TableWrapper(d), j2, modes.INNER, ("dk", "k"))
        return j2, j3
    j2, j3 = plan(jax_ops, jax_ast, JaxJoinMode, jt, jd)
    p2, p3 = plan(torch_ops, torch_ast, JoinMode, pt, pd_)
    want, got = jax_ops.execute_plan(j3), torch_ops.execute_plan(p3)
    assert p2.path == "lut" and p3.path == "ranges"
    assert got.column_names == want.column_names
    _assert_rows_equal(got.rows(), want.rows())
    _assert_rows_equal(p2.get_output().rows(), j2.get_output().rows())


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

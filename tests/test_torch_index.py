"""Indexes, IndexScan, JoinIndex and the IndexScanRule: hyrise_tpu_torch
against hyrise_tpu on the same exported tables, on CPU tensors.

- create_index: perm[:n_valid], n_valid and a string column's GroupKeyIndex
  offsets equal the JAX package's, with ties, NULLs and dead rows (a masked
  table); the composite index's too.
- IndexScan over every condition and literals present, absent, below the
  minimum and above the maximum, of every column type: the rows of the JAX
  package's IndexScan (in its order) and of the port's TableScan.
- The cases of tests/test_index_composite.py, tests/test_r5_advisor_fixes.py
  (the fallback keeps extra_equals) and tests/test_join_full_matrix.py (the
  optimizer selects IndexScan).
- JoinIndex in every mode and condition equals Join, rows in order, with
  `index_used` True where the build input carries the index.
- ROADMAP C15: NULL rows and NaN values never fall in a comparison's range
  (the JAX package's index sorts NaN behind the NULLs and returns them);
  C16: a fractional or out-of-range literal on an integral column gives
  TableScan's rows (the JAX TableScan is at fault there, so the port is
  held against sqlite)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyrise_tpu.expression.ast as jax_ast
import hyrise_tpu.ops as jax_ops
from hyrise_tpu.ops.index_scan import IndexScan as JaxIndexScan
from hyrise_tpu.plan import lqp as jax_lqp
from hyrise_tpu.plan.optimizer import IndexScanRule as JaxIndexScanRule
from hyrise_tpu.plan.optimizer import Optimizer as JaxOptimizer
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.storage.index import create_index as jax_create_index
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu.types import PredicateCondition as JaxCond
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops import IndexScan, JoinIndex, TableWrapper, execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.optimizer import IndexScanRule, Optimizer
from hyrise_tpu_torch.plan.translator import translate_lqp
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.index import (CompositeSortedIndex, GroupKeyIndex,
                                            SortedIndex, create_index,
                                            find_composite_index, get_index)
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import JoinMode, PredicateCondition
from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

P = PredicateCondition
T = JaxDataType
CONDS = ["EQUALS", "LESS_THAN", "LESS_THAN_EQUALS", "GREATER_THAN",
         "GREATER_THAN_EQUALS", "BETWEEN"]
TYPES = ["int32", "int64", "float32", "float64", "string"]


def _port_table(jt: JaxTable) -> Table:
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(jt.name, cols, jt.num_rows, live, device="cpu",
                            unique=[c.name for c in jt.columns if c.unique])


def _column_values(dtype: str, n: int, rng):
    """n values with many ties (about 40 distinct), of the given type; floats
    exact in float32 so that both packages compare them alike."""
    keys = rng.integers(0, 40, n)
    if dtype == "string":
        return np.array([f"s{k:02d}" for k in keys], dtype=object)
    if dtype.startswith("int"):
        return (keys * 3 - 30).astype(dtype)
    return (keys / 4 - 3).astype(dtype)


def _jax_table(dtype: str, n: int = 2000, seed: int = 0, masked: bool = False) -> JaxTable:
    rng = np.random.default_rng(seed)
    jt = JaxTable.from_arrays(
        "t", [JaxDef("c", T(dtype), True), JaxDef("row", T.INT32)],
        [_column_values(dtype, n, rng), np.arange(n, dtype=np.int32)],
        [rng.random(n) >= 0.1, None])
    if masked:  # dead rows among the live ones
        live = np.zeros(jt.capacity, dtype=bool)
        live[:n] = rng.random(n) >= 0.3
        jt = JaxTable(jt.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    return jt


# -- index builds ----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("dtype", TYPES)
def test_index_order_equals_jax(dtype, masked):
    jt = _jax_table(dtype, seed=len(dtype), masked=masked)
    t = _port_table(jt)
    jidx, idx = jax_create_index(jt, "c"), create_index(t, "c")
    assert idx.n_valid == jidx.n_valid == idx.n_ordered
    np.testing.assert_array_equal(idx.perm.numpy(), np.asarray(jidx.perm)[:jidx.n_valid])
    np.testing.assert_array_equal(idx.sorted_values.numpy(),
                                  np.asarray(jidx.sorted_values)[:jidx.n_valid])
    assert get_index(t, "c") is idx
    if dtype == "string":
        assert isinstance(idx, GroupKeyIndex) and isinstance(jidx, type(jidx))
        np.testing.assert_array_equal(idx.offsets, jidx.offsets)
    else:
        assert type(idx) is SortedIndex


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
def test_composite_index_order_equals_jax(masked):
    rng = np.random.default_rng(9)
    n = 3000
    jt = JaxTable.from_arrays(
        "t", [JaxDef("a", T.INT32), JaxDef("b", T.INT64, True), JaxDef("s", T.STRING)],
        [rng.integers(0, 20, n).astype(np.int32), rng.integers(0, 50, n).astype(np.int64),
         np.array([f"w{k}" for k in rng.integers(0, 4, n)], dtype=object)],
        [None, rng.random(n) >= 0.05, None])
    if masked:
        live = np.zeros(jt.capacity, dtype=bool)
        live[:n] = rng.random(n) >= 0.2
        jt = JaxTable(jt.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    t = _port_table(jt)
    for cols in (["a", "b"], ["s", "a", "b"], ["b", "s"]):
        jidx, idx = jax_create_index(jt, cols), create_index(t, cols)
        assert isinstance(idx, CompositeSortedIndex) and idx.columns == tuple(cols)
        assert idx.n_valid == jidx.n_valid
        np.testing.assert_array_equal(idx.perm.numpy(), np.asarray(jidx.perm)[:jidx.n_valid])
        for probe in ([3, 17], [19, 49], [0], [5, 999], [-1]):
            values = probe[:len(cols)]
            if cols[0] == "s":
                values = [2] + values[:len(cols) - 1]
            assert idx.lookup_equals(values) == jidx.lookup_equals(values)
        assert find_composite_index(t, cols[:2]) is not None


# -- IndexScan against the JAX IndexScan and the port's TableScan ------------------


def _literals(dtype: str, present: np.ndarray):
    if dtype == "string":
        words = sorted(set(present))
        return [words[len(words) // 2], "s10x", "a", "zz", words[0], words[-1]]
    lo, hi, mid = present.min(), present.max(), np.sort(present)[len(present) // 2]
    if dtype.startswith("int"):
        return [int(mid), int(mid) + 1, int(lo) - 7, int(hi) + 7, int(lo), int(hi)]
    return [float(mid), float(mid) + 0.125, float(lo) - 1.0, float(hi) + 1.0, float(lo),
            float(hi)]


def _comparison(cond: str, v, v2, module):
    col, lit = module.col("c"), module.lit
    if cond == "BETWEEN":
        return col.between(v, v2)
    cls = module.Comparison
    return cls((P if module is ast else JaxCond)[cond], col, lit(v))


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("dtype", TYPES)
def test_index_scan_equals_jax_and_table_scan(dtype, cond, masked):
    jt = _jax_table(dtype, seed=3, masked=masked)
    t = _port_table(jt)
    jax_create_index(jt, "c")
    create_index(t, "c")
    present = t.column("c").decode(t.capacity)[
        t.live_mask().numpy() & t.column("c").validity.numpy()]
    lits = _literals(dtype, present)
    for v in lits:
        v2 = lits[(lits.index(v) + 1) % len(lits)]
        scan = IndexScan(TableWrapper(t), "c", P[cond], v, v2)
        got = execute_plan(scan).rows()
        assert "index_fallback" not in scan.performance_data.extra
        want = jax_ops.execute_plan(JaxIndexScan(jax_ops.TableWrapper(jt), "c",
                                                 JaxCond[cond], v, v2)).rows()
        assert got == want, (cond, v, v2)
        ref = execute_plan(TableScan(TableWrapper(t), _comparison(cond, v, v2, ast))).rows()
        assert sorted(got, key=lambda r: r[1]) == sorted(ref, key=lambda r: r[1])


@pytest.mark.parametrize("cond", ["NOT_EQUALS", "LIKE", "NOT_LIKE", "IS_NULL",
                                  "IS_NOT_NULL", "IN", "NOT_IN"])
def test_index_scan_falls_back_to_a_table_scan(cond):
    jt = _jax_table("string", seed=5)
    t = _port_table(jt)
    create_index(t, "c")
    jax_create_index(jt, "c")
    value = {"NOT_EQUALS": "s07", "LIKE": "s1%", "NOT_LIKE": "%3", "IN": ["s01", "s33"],
             "NOT_IN": ["s01", "s33"]}.get(cond)
    scan = IndexScan(TableWrapper(t), "c", P[cond], value)
    got = execute_plan(scan).rows()
    assert scan.performance_data.extra.get("index_fallback") is True
    want = jax_ops.execute_plan(JaxIndexScan(jax_ops.TableWrapper(jt), "c", JaxCond[cond],
                                             value)).rows()
    assert got == want


def test_index_scan_without_an_index_is_a_table_scan():
    t = _port_table(_jax_table("int64", seed=6))
    scan = IndexScan(TableWrapper(t), "c", P.EQUALS, 30)
    out = execute_plan(scan)
    assert scan.performance_data.extra.get("index_fallback") is True
    ref = execute_plan(TableScan(TableWrapper(t), ast.col("c") == ast.lit(30)))
    assert out.rows() == ref.rows()


# -- tests/test_index_composite.py ------------------------------------------------


@pytest.fixture()
def env():
    """(JAX table, port table, port catalog) of tests/test_index_composite.py."""
    rng = np.random.default_rng(7)
    n = 5000
    b_valid = np.ones(n, dtype=bool)
    b_valid[rng.choice(n, 100, replace=False)] = False
    jt = JaxTable.from_arrays(
        "t", [JaxDef("a", T.INT32), JaxDef("b", T.INT64, True), JaxDef("s", T.STRING),
              JaxDef("v", T.FLOAT32)],
        [rng.integers(0, 20, n).astype(np.int32), rng.integers(0, 50, n).astype(np.int64),
         rng.choice(["red", "green", "blue", "teal"], n).astype(object),
         rng.normal(size=n).astype(np.float32)],
        [None, b_valid, None, None])
    t = _port_table(jt)
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    return jt, t, cat


def _count(t: Table, pred) -> int:
    return execute_plan(TableScan(TableWrapper(t), pred)).num_rows


def test_composite_index_lookup_matches_filter(env):
    jt, t, _ = env
    idx = create_index(t, ["a", "b"])
    assert idx.columns == ("a", "b")
    for a, b in [(3, 17), (19, 49), (0, 0), (5, 999)]:
        start, end = idx.lookup_equals([a, b])
        assert end - start == _count(t, (ast.col("a") == ast.lit(a)) & (ast.col("b") == ast.lit(b)))
    start, end = idx.lookup_equals([3])  # a prefix: rows with a NULL b are not in it
    assert end - start == _count(t, (ast.col("a") == ast.lit(3))
                                 & ast.IsNull(ast.col("b"), negate=True))


def test_composite_index_scan_matches_table_scan(env):
    jt, t, cat = env
    create_index(t, ["a", "s"])
    scan = IndexScan(GetTable("t", cat), "a", P.EQUALS, 7, extra_equals=[("s", "green")])
    got = execute_plan(scan)
    pred = (ast.col("a") == ast.lit(7)) & (ast.col("s") == ast.lit("green"))
    ref = execute_plan(TableScan(GetTable("t", cat), pred))
    assert_tables_equal(got.rows(), ref.rows(), ordered=False, rel_tol=0, abs_tol=0)
    assert scan.performance_data.extra.get("composite_index") == ("a", "s")
    jax_create_index(jt, ["a", "s"])
    want = jax_ops.execute_plan(JaxIndexScan(jax_ops.TableWrapper(jt), "a", JaxCond.EQUALS, 7,
                                             extra_equals=[("s", "green")])).rows()
    assert got.rows() == want


def test_composite_index_absent_value_is_empty(env):
    _, t, cat = env
    create_index(t, ["a", "s"])
    scan = IndexScan(GetTable("t", cat), "a", P.EQUALS, 7, extra_equals=[("s", "mauve")])
    assert execute_plan(scan).num_rows == 0
    scan = IndexScan(GetTable("t", cat), "a", P.EQUALS, 7.5, extra_equals=[("s", "red")])
    assert execute_plan(scan).num_rows == 0


def test_optimizer_selects_composite_index(env):
    jt, t, cat = env
    create_index(t, ["a", "s"])
    stored = L.StoredTableNode("t")
    p1 = L.PredicateNode(ast.col("a") == ast.lit(7), stored)
    p2 = L.PredicateNode(ast.col("s") == ast.lit("green"), p1)
    root = IndexScanRule().apply(p2, cat)
    assert p1.use_index_composite == ("a", 7, [("s", "green")])
    # the JAX rule marks the same predicate the same way
    jax_create_index(jt, ["a", "s"])
    jcat = JaxCatalog()
    jcat.add_table("t", jt)
    jp1 = jax_lqp.PredicateNode(jax_ast.col("a") == jax_ast.lit(7), jax_lqp.StoredTableNode("t"))
    jp2 = jax_lqp.PredicateNode(jax_ast.col("s") == jax_ast.lit("green"), jp1)
    JaxIndexScanRule().apply(jp2, jcat)
    assert jp1.use_index_composite == p1.use_index_composite
    got = execute_plan(translate_lqp(root, cat))
    pred = (ast.col("a") == ast.lit(7)) & (ast.col("s") == ast.lit("green"))
    ref = execute_plan(TableScan(GetTable("t", cat), pred))
    assert_tables_equal(got.rows(), ref.rows(), ordered=False, rel_tol=0, abs_tol=0)


def _dim_fact(seed=3, n=4000, m=300):
    rng = np.random.default_rng(seed)
    fact = table_from_numpy("fact", [
        ("k", "int64", rng.integers(0, m + 20, n).astype(np.int64), rng.random(n) >= 0.05,
         None),
        ("v", "float64", rng.normal(size=n), None, None)], n, device="cpu")
    dim = table_from_numpy("dim", [
        ("k", "int64", rng.permutation(m).astype(np.int64), None, None),
        ("w", "float64", rng.normal(size=m), None, None)], m, device="cpu")
    return fact, dim


@pytest.mark.parametrize("mode", ["INNER", "LEFT", "RIGHT", "OUTER", "SEMI", "ANTI",
                                  "ANTI_NULL_AS_TRUE"])
def test_join_index_uses_index_and_matches(mode):
    fact, dim = _dim_fact()
    create_index(dim, "k")
    if mode == "RIGHT":  # RIGHT probes dim against the fact side
        create_index(fact, "k")
    ref = execute_plan(Join(TableWrapper(fact), TableWrapper(dim), JoinMode[mode], ("k", "k")))
    ji = JoinIndex(TableWrapper(fact), TableWrapper(dim), JoinMode[mode], ("k", "k"))
    got = execute_plan(ji)
    assert got.rows() == ref.rows()
    assert ji.performance_data.extra.get("index_used") is True
    assert ji.path == "ranges"


def test_join_index_falls_back_without_index():
    fact, dim = _dim_fact(seed=9)
    ji = JoinIndex(TableWrapper(fact), TableWrapper(dim), JoinMode.INNER, ("k", "k"))
    got = execute_plan(ji)
    ref = execute_plan(Join(TableWrapper(fact), TableWrapper(dim), JoinMode.INNER, ("k", "k")))
    assert got.rows() == ref.rows()
    assert ji.performance_data.extra.get("index_used") is False


def test_join_index_does_not_serve_a_compacted_build_side():
    """A masked build input is compacted into a new table before the sorted
    join: its row ids are no longer the index's."""
    fact, dim = _dim_fact(seed=4)
    live = torch.arange(dim.capacity) % 2 == 0
    masked = Table(dim.columns, int(live.sum()), name="dim", live=live)
    create_index(masked, "k")
    ji = JoinIndex(TableWrapper(fact), TableWrapper(masked), JoinMode.INNER, ("k", "k"))
    got = execute_plan(ji)
    ref = execute_plan(Join(TableWrapper(fact), TableWrapper(masked), JoinMode.INNER,
                            ("k", "k")))
    assert got.rows() == ref.rows()
    assert ji.performance_data.extra.get("index_used") is False


@pytest.mark.parametrize("cond", ["EQUALS", "NOT_EQUALS", "LESS_THAN", "LESS_THAN_EQUALS",
                                  "GREATER_THAN", "GREATER_THAN_EQUALS"])
@pytest.mark.parametrize("mode", ["INNER", "LEFT", "RIGHT", "OUTER", "SEMI", "ANTI",
                                  "ANTI_NULL_AS_TRUE"])
@pytest.mark.parametrize("kind", ["int", "float", "string"])
def test_join_index_equals_join_in_order(kind, mode, cond):
    """Keys with ties and NULLs on both sides; the build side (the probe
    side's for RIGHT) carries the index."""
    rng = np.random.default_rng(len(kind) + len(mode))
    n, m = 61, 47
    if kind == "string":
        words = np.array(["ant", "bee", "cat", "dog", "eel"])
        lk, rk = rng.integers(0, 5, n).astype(np.int32), rng.integers(0, 5, m).astype(np.int32)
        spec, dictionary = "string", words
    else:
        lk, rk = rng.integers(0, 9, n), rng.integers(0, 9, m)
        spec = "int64" if kind == "int" else "float64"
        lk, rk = (lk, rk) if kind == "int" else (lk / 2, rk / 2)
        dictionary = None
    lt = table_from_numpy("l", [("a", spec, lk, rng.random(n) >= 0.1, dictionary),
                                ("lv", "int32", np.arange(n, dtype=np.int32), None, None)],
                          n, device="cpu")
    rt = table_from_numpy("r", [("b", spec, rk, rng.random(m) >= 0.1, dictionary),
                                ("rv", "int32", np.arange(m, dtype=np.int32), None, None)],
                          m, device="cpu")
    build, col = (lt, "a") if mode == "RIGHT" else (rt, "b")
    create_index(build, col)
    args = (JoinMode[mode], ("a", "b"), P[cond])
    ref = execute_plan(Join(TableWrapper(lt), TableWrapper(rt), *args))
    ji = JoinIndex(TableWrapper(lt), TableWrapper(rt), *args)
    got = execute_plan(ji)
    assert got.rows() == ref.rows()
    assert ji.performance_data.extra.get("index_used") is True


# -- tests/test_r5_advisor_fixes.py and tests/test_join_full_matrix.py --------------


@pytest.mark.parametrize("cond,value,value2", [
    (P.BETWEEN, 5, 12), (P.IS_NOT_NULL, None, None)])
def test_index_scan_fallback_keeps_extra_equals(cond, value, value2):
    rng = np.random.default_rng(11)
    n = 2000
    t = table_from_numpy("t", [
        ("a", "int64", rng.integers(0, 20, n).astype(np.int64), None, None),
        ("s", "string", rng.integers(0, 3, n).astype(np.int32), None,
         np.array(["blue", "green", "red"]))], n, device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    create_index(t, ["a"])  # no composite on (a, s): the fallback path
    scan = IndexScan(GetTable("t", cat), "a", cond, value, value2, extra_equals=[("s", "red")])
    out = execute_plan(scan)
    a, s = t.column("a").data.numpy(), t.column("s").data.numpy()
    mask = (a >= 5) & (a <= 12) if cond is P.BETWEEN else np.ones(n, dtype=bool)
    assert out.num_rows == int((mask & (s == 2)).sum())
    assert scan.performance_data.extra.get("index_fallback") is True


def test_index_scan_like_fallback_keeps_extra_equals():
    words = np.array(["apple", "apricot", "avocado", "banana"])
    t = table_from_numpy("t", [
        ("s", "string", np.array([0, 1, 3, 0, 2], dtype=np.int32), None, words),
        ("g", "string", np.array([0, 1, 0, 1, 0], dtype=np.int32), None,
         np.array(["x", "y"]))], 5, device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    create_index(t, ["s"])
    scan = IndexScan(GetTable("t", cat), "s", P.LIKE, "ap%", extra_equals=[("g", "y")])
    assert execute_plan(scan).num_rows == 2  # apricot (y) and apple (y)


def _mark(mark):
    """An index mark with its condition as the enum's value (the packages'
    PredicateCondition enums are distinct classes)."""
    return None if mark is None else tuple(getattr(x, "value", x) for x in mark)


def test_optimizer_selects_index_scan_like_jax():
    rng = np.random.default_rng(1)
    jt = JaxTable.from_arrays("t", [JaxDef("k", T.INT64), JaxDef("v", T.FLOAT64)],
                              [rng.integers(0, 1000, size=500).astype(np.int64),
                               rng.normal(size=500)])
    t = _port_table(jt)
    create_index(t, "k")
    jax_create_index(jt, "k")
    cat, jcat = Catalog(device="cpu"), JaxCatalog()
    cat.add_table("t", t)
    jcat.add_table("t", jt)
    for pred, jpred, chosen in [
            (ast.col("k") < ast.lit(100), jax_ast.col("k") < jax_ast.lit(100), True),
            (ast.lit(100) > ast.col("k"), jax_ast.lit(100) > jax_ast.col("k"), True),
            (ast.col("k").between(10, 20), jax_ast.col("k").between(10, 20), True),
            (ast.col("v") < ast.lit(0.0), jax_ast.col("v") < jax_ast.lit(0.0), False)]:
        node = L.PredicateNode(pred, L.StoredTableNode("t"))
        jnode = jax_lqp.PredicateNode(jpred, jax_lqp.StoredTableNode("t"))
        opt = Optimizer().optimize(node, cat)
        jopt = JaxOptimizer().optimize(jnode, jcat)
        assert _mark(getattr(opt, "use_index", None)) == \
            _mark(getattr(jopt, "use_index", None))
        pqp = translate_lqp(opt, cat)
        assert ("IndexScan" in pqp.describe()) is chosen
        out = execute_plan(pqp)
        ref = execute_plan(TableScan(TableWrapper(t), pred))
        assert_tables_equal(out.rows(), ref.rows(), ordered=False, rel_tol=0, abs_tol=0)


# -- C15 and C16 ------------------------------------------------------------------


def _float_table(values, validity=None) -> Table:
    return table_from_numpy("t", [("a", "float64", np.array(values), validity, None),
                                  ("r", "int32", np.arange(len(values), dtype=np.int32),
                                   None, None)], len(values), device="cpu")


@pytest.mark.parametrize("cond,value,rows", [
    ("GREATER_THAN", 5.0, [2]), ("GREATER_THAN_EQUALS", 1.0, [0, 2]),
    ("LESS_THAN", 100.0, [0, 2]), ("LESS_THAN_EQUALS", 7.0, [0, 2]), ("EQUALS", 7.0, [2])])
def test_c15_null_rows_are_never_in_a_range(cond, value, rows):
    """[1.0, NaN, 7.0, NULL]: the JAX index sorts the NaN behind the NULL
    row, counts it in n_valid, and `a > 5` returns 7.0 and the NULL row."""
    t = _float_table([1.0, np.nan, 7.0, 0.0], np.array([True, True, True, False]))
    idx = create_index(t, "a")
    assert idx.n_valid == 3 and idx.n_ordered == 2
    assert 3 not in idx.perm.tolist()  # the NULL row
    got = execute_plan(IndexScan(TableWrapper(t), "a", P[cond], value))
    assert [r[1] for r in got.rows()] == rows
    ref = execute_plan(TableScan(TableWrapper(t), ast.Comparison(P[cond], ast.col("a"),
                                                                 ast.lit(value))))
    assert sorted(r[1] for r in ref.rows()) == rows
    assert SqliteOracle({"t": t}).query(
        f"SELECT r FROM t WHERE a {P[cond].value.replace('<>', '!=')} {value} ORDER BY r") == \
        [(r,) for r in rows]


def test_c15_the_jax_index_returns_the_null_row():
    jt = JaxTable.from_arrays("t", [JaxDef("a", T.FLOAT64, True)],
                              [np.array([1.0, np.nan, 7.0, 0.0])],
                              [np.array([True, True, True, False])])
    jax_create_index(jt, "a")
    rows = jax_ops.execute_plan(JaxIndexScan(jax_ops.TableWrapper(jt), "a",
                                             JaxCond.GREATER_THAN, 5.0)).rows()
    assert len(rows) == 2 and (None,) in rows  # the fault the port does not copy
    t = _float_table([1.0, np.nan, 7.0, 0.0], np.array([True, True, True, False]))
    create_index(t, "a")
    assert [r[0] for r in execute_plan(IndexScan(TableWrapper(t), "a", P.GREATER_THAN,
                                                 5.0)).rows()] == [7.0]


@pytest.mark.parametrize("cond,value,count", [
    ("GREATER_THAN", 5.0, 1), ("GREATER_THAN_EQUALS", 2.0, 2), ("BETWEEN", (2.0, 8.0), 2),
    ("LESS_THAN", float("inf"), 3), ("EQUALS", float("nan"), 0),
    ("GREATER_THAN", float("nan"), 0)])
def test_c15_nan_is_in_no_range(cond, value, count):
    """[1.0, NaN, 7.0, 3.0] without NULLs: the NaN row matches no comparison."""
    t = _float_table([1.0, np.nan, 7.0, 3.0])
    create_index(t, "a")
    v, v2 = value if isinstance(value, tuple) else (value, None)
    got = execute_plan(IndexScan(TableWrapper(t), "a", P[cond], v, v2))
    pred = ast.col("a").between(v, v2) if cond == "BETWEEN" else \
        ast.Comparison(P[cond], ast.col("a"), ast.lit(v))
    ref = execute_plan(TableScan(TableWrapper(t), pred))
    assert got.num_rows == ref.num_rows == count
    assert sorted(got.rows()) == sorted(ref.rows())


@pytest.mark.parametrize("cond,value", [
    (c, v) for c in CONDS[:-1]
    for v in (5.5, 5.0, -0.5, 2**31 + 0.5, 1099511627776, -(2**40), 2147483647, -2147483648)])
def test_c16_index_scan_gives_table_scan_rows(cond, value):
    """An INT32 column [1, 5, 9, 2147483647]: IndexScan, TableScan and sqlite
    agree on fractional and out-of-range literals."""
    t = table_from_numpy("t", [("a", "int32", np.array([1, 5, 9, 2**31 - 1], dtype=np.int32),
                                None, None)], 4, device="cpu")
    create_index(t, "a")
    got = execute_plan(IndexScan(TableWrapper(t), "a", P[cond], value)).rows()
    ref = execute_plan(TableScan(TableWrapper(t), ast.Comparison(P[cond], ast.col("a"),
                                                                 ast.lit(value)))).rows()
    want = SqliteOracle({"t": t}).query(
        f"SELECT a FROM t WHERE a {P[cond].value} {value!r} ORDER BY a")
    assert sorted(got) == sorted(ref) == want

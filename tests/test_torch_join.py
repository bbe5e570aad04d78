"""Join parity: hyrise_tpu_torch.ops.join against hyrise_tpu.ops.join on the
same exported tables, mirroring tests/test_join.py, test_join_lookup.py and
test_join_full_matrix.py: every mode x condition x key kind (integer keys
with NULLs, string keys with equal and with unequal dictionaries, float
keys, a unique build key), the operator aliases, JoinNestedLoop, Product,
empty and masked inputs, and what the lookup path needs of the column
metadata. Rows must be equal as ORDERED lists (the port keeps the JAX
engine's pair order), integers and strings exactly, NULLs in the same
cells."""

import jax.numpy as jnp
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
from hyrise_tpu.types import JoinMode as JaxJoinMode
from hyrise_tpu.types import PredicateCondition as JaxCond
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import JoinMode, PredicateCondition

torch.set_num_threads(1)

MODES = ["INNER", "LEFT", "RIGHT", "OUTER", "SEMI", "ANTI", "ANTI_NULL_AS_TRUE"]
CONDS = ["EQUALS", "NOT_EQUALS", "LESS_THAN", "LESS_THAN_EQUALS", "GREATER_THAN",
         "GREATER_THAN_EQUALS"]
T = JaxDataType


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy(
        jt.name, cols, jt.num_rows, live, device="cpu",
        unique=[c.name for c in jt.columns if c.unique],
        val_ranges={c.name: c.val_range for c in jt.columns})


def _mask(jt: JaxTable, keep: np.ndarray) -> JaxTable:
    """jt in masked layout, its live rows those of `keep` (over num_rows)."""
    live = np.zeros(jt.capacity, dtype=bool)
    live[:jt.num_rows] = keep
    return JaxTable(jt.columns, int(live.sum()), name=jt.name, live=jnp.asarray(live))


def _tables(kind: str, seed: int = 0, n: int = 23, m: int = 17,
            build_nulls: bool = True):
    """(left, right) JAX tables with key columns a and b of the given kind
    (NULLs among both, unless build_nulls is False) and payload columns lv
    and rv."""
    rng = np.random.default_rng(seed)
    lvalid, rvalid = rng.random(n) > 0.2, rng.random(m) > 0.2
    if not build_nulls:
        rvalid = None
    if kind in ("int_nulls", "int_unique_build"):
        la = rng.integers(0, 8, n).astype(np.int64)
        rb = rng.integers(0, 8, m).astype(np.int64)
        key_t = T.INT64
        if kind == "int_unique_build":
            rb = rng.permutation(np.arange(-3, m - 3)).astype(np.int64)
            la = rng.integers(-5, m, n).astype(np.int64)
    elif kind == "float":
        la = rng.integers(0, 8, n) / 4.0
        rb = rng.integers(0, 8, m) / 4.0
        key_t = T.FLOAT64
    else:
        words = np.array(["ant", "bee", "cat", "dog", "eel", "fox"], dtype=object)
        la = words[rng.integers(0, 6, n)]
        # "other" dictionary: values the left side lacks, one sorting last
        rwords = words if kind == "string_same_dict" else \
            np.array(["bee", "cow", "dog", "fox", "zebu", "ant"], dtype=object)
        rb = rwords[rng.integers(0, 6, m)]
        if kind == "string_same_dict":
            la[:6], rb[:6] = words, words  # both dictionaries hold all words
        key_t = T.STRING
    lt = JaxTable.from_arrays(
        "l", [JaxDef("a", key_t, True), JaxDef("lv", T.INT32)],
        [la, np.arange(n, dtype=np.int32)], [lvalid, None])
    rt = JaxTable.from_arrays(
        "r", [JaxDef("b", key_t, True), JaxDef("rv", T.INT32)],
        [rb, np.arange(100, 100 + m, dtype=np.int32)], [rvalid, None])
    if kind == "int_unique_build":
        rt.column("b").unique = True
    return lt, rt


def _both(lt, rt, mode, cond="EQUALS", cls="Join", pair=("a", "b")):
    """The same join over the JAX tables and their port copies:
    (port output, JAX output, port operator)."""
    jop = getattr(jax_ops, cls)(jax_ops.TableWrapper(lt), jax_ops.TableWrapper(rt),
                                getattr(JaxJoinMode, mode), pair, getattr(JaxCond, cond))
    pop = getattr(torch_ops, cls)(
        torch_ops.TableWrapper(_port_table(lt)), torch_ops.TableWrapper(_port_table(rt)),
        getattr(JoinMode, mode), pair, getattr(PredicateCondition, cond))
    return torch_ops.execute_plan(pop), jax_ops.execute_plan(jop), pop


def _assert_same(pout, jout):
    assert pout.column_names == jout.column_names
    assert [c.dtype.value for c in pout.columns] == [c.dtype.value for c in jout.columns]
    got, want = pout.rows(), jout.rows()
    assert pout.num_rows == len(got)
    assert got == want


def _canonical(rows):
    """Rows as a sorted list of comparable tuples (for unordered equality)."""
    def cell(v):
        if v is None:
            return (0, "")
        return (1, v) if isinstance(v, str) else (2, float(v))
    return sorted(tuple(cell(v) for v in r) for r in rows)


KINDS = ["int_nulls", "string_same_dict", "string_other_dict", "float",
         "int_unique_build"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("mode", MODES)
def test_join_matrix_matches_jax(mode, cond, kind):
    lt, rt = _tables(kind)
    pout, jout, op = _both(lt, rt, mode, cond)
    _assert_same(pout, jout)
    if cond != "EQUALS" or (mode in ("OUTER", "RIGHT")) or \
            (mode in ("INNER", "LEFT") and kind != "int_unique_build"):
        assert op.path == "ranges"
    else:
        assert op.path == ("lookup" if kind == "float" else "lut")


@pytest.mark.parametrize("kind", ["int_nulls", "string_other_dict", "int_unique_build"])
@pytest.mark.parametrize("mode", MODES)
def test_equi_join_matches_jax_fast_forms(mode, kind, monkeypatch):
    # the JAX engine's other formulation: LUT probes, masked filter outputs
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", "1")
    lt, rt = _tables(kind, seed=4)
    _assert_same(*_both(lt, rt, mode)[:2])


@pytest.mark.parametrize("cls", ["JoinHash", "JoinSortMerge", "JoinMPSM"])
@pytest.mark.parametrize("mode", ["INNER", "LEFT", "OUTER", "SEMI"])
def test_join_aliases_match_jax(cls, mode):
    lt, rt = _tables("int_nulls", seed=1)
    _assert_same(*_both(lt, rt, mode, cls=cls)[:2])


def test_join_hash_is_equi_only():
    lt, rt = _tables("int_nulls")
    with pytest.raises(ValueError):
        torch_ops.JoinHash(torch_ops.TableWrapper(_port_table(lt)),
                           torch_ops.TableWrapper(_port_table(rt)), JoinMode.INNER,
                           ("a", "b"), PredicateCondition.LESS_THAN)
    _assert_same(*_both(lt, rt, "INNER", "LESS_THAN", cls="JoinSortMerge")[:2])


@pytest.mark.parametrize("kind", ["int_nulls", "string_other_dict"])
@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("mode", MODES)
def test_nested_loop_matches_jax_and_the_engine(mode, cond, kind):
    lt, rt = _tables(kind, seed=2)
    pout, jout, _ = _both(lt, rt, mode, cond, cls="JoinNestedLoop")
    _assert_same(pout, jout)
    engine = _both(lt, rt, mode, cond)[0]
    assert _canonical(pout.rows()) == _canonical(engine.rows())


def test_product_matches_jax():
    lt, rt = _tables("int_nulls", seed=3, n=5, m=4)
    for left, right in ((lt, rt), (_mask(lt, np.arange(5) % 2 == 0), rt)):
        jout = jax_ops.execute_plan(jax_ops.Product(jax_ops.TableWrapper(left),
                                                    jax_ops.TableWrapper(right)))
        pout = torch_ops.execute_plan(torch_ops.Product(
            torch_ops.TableWrapper(_port_table(left)),
            torch_ops.TableWrapper(_port_table(right))))
        _assert_same(pout, jout)
        assert pout.num_rows == left.num_rows * 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("kind", ["int_nulls", "int_unique_build"])
def test_empty_inputs_match_jax(kind, empty, mode):
    lt, rt = _tables(kind)
    if empty in ("left", "both"):
        lt = _mask(lt, np.zeros(lt.num_rows, dtype=bool))
    if empty in ("right", "both"):
        rt = _mask(rt, np.zeros(rt.num_rows, dtype=bool))
    _assert_same(*_both(lt, rt, mode)[:2])


def test_join_with_an_empty_unpadded_build_side():
    """A base table of the port holds exactly its rows, so a build side can
    have capacity 0 (the JAX package pads to at least one row)."""
    lt, _ = _tables("int_unique_build")
    probe = _port_table(lt)
    empty = table_from_numpy("r", [("b", "int64", np.zeros(0, np.int64), None, None),
                                   ("rv", "int32", np.zeros(0, np.int32), None, None)],
                             0, device="cpu", unique=["b"])
    for mode, rows in ((JoinMode.INNER, 0), (JoinMode.LEFT, lt.num_rows),
                       (JoinMode.OUTER, lt.num_rows), (JoinMode.ANTI, lt.num_rows),
                       (JoinMode.SEMI, 0), (JoinMode.RIGHT, 0)):
        out = torch_ops.execute_plan(Join(torch_ops.TableWrapper(probe),
                                          torch_ops.TableWrapper(empty), mode, ("a", "b")))
        assert out.num_rows == rows == len(out.rows()), mode
        if rows and mode not in (JoinMode.ANTI,):
            assert all(r[2] is None and r[3] is None for r in out.rows())


@pytest.mark.parametrize("kind", ["int_nulls", "int_unique_build"])
@pytest.mark.parametrize("masked", ["left", "right", "both"])
@pytest.mark.parametrize("mode", MODES)
def test_masked_inputs_match_jax(mode, masked, kind):
    lt, rt = _tables(kind, seed=6)
    rng = np.random.default_rng(9)
    if masked in ("left", "both"):
        lt = _mask(lt, rng.random(lt.num_rows) < 0.6)
    if masked in ("right", "both"):
        rt = _mask(rt, rng.random(rt.num_rows) < 0.6)
    _assert_same(*_both(lt, rt, mode)[:2])


def test_key_promotion_matches_jax():
    rng = np.random.default_rng(11)
    lt = JaxTable.from_arrays("l", [JaxDef("a", T.INT32), JaxDef("lv", T.INT32)],
                              [rng.integers(0, 6, 20).astype(np.int32),
                               np.arange(20, dtype=np.int32)])
    for key_t, keys in ((T.INT64, rng.integers(0, 6, 9).astype(np.int64)),
                        (T.FLOAT32, (rng.integers(0, 12, 9) / 2).astype(np.float32))):
        rt = JaxTable.from_arrays("r", [JaxDef("b", key_t), JaxDef("rv", T.INT32)],
                                  [keys, np.arange(9, dtype=np.int32)])
        for mode in ("INNER", "OUTER", "ANTI"):
            _assert_same(*_both(lt, rt, mode)[:2])
    st = JaxTable.from_arrays("s", [JaxDef("b", T.STRING)],
                              [np.array(["x", "y"], dtype=object)])
    with pytest.raises(TypeError):
        _both(lt, st, "INNER")


def test_duplicate_heavy_keys_match_jax():
    lt = JaxTable.from_arrays("l", [JaxDef("a", T.INT32), JaxDef("lv", T.INT32)],
                              [np.zeros(40, np.int32), np.arange(40, dtype=np.int32)])
    rt = JaxTable.from_arrays("r", [JaxDef("b", T.INT32), JaxDef("rv", T.INT32)],
                              [np.zeros(30, np.int32), np.arange(30, dtype=np.int32)])
    pout, jout, _ = _both(lt, rt, "INNER")
    assert pout.num_rows == 1200
    _assert_same(pout, jout)


# -- the lookup path and the column metadata -----------------------------------------


def _plan(ops, A, modes, conds, tables):
    """A chain over orders / customer / lineitem-like tables: filter the
    unique-key table, join it to a second unique-key table, then join a
    fact table to the result."""
    to, tc, tl = (ops.TableWrapper(t) for t in tables)
    scan = ops.TableScan(to, A.col("o_id") < 50)
    j1 = ops.Join(scan, tc, modes.INNER, ("o_ck", "c_id"))
    j2 = ops.Join(tl, j1, modes.INNER, ("l_oid", "o_id"))
    return j1, j2


def _chain_tables():
    to = JaxTable.from_arrays("O", [JaxDef("o_id", T.INT32), JaxDef("o_ck", T.INT32)],
                              [np.arange(100, dtype=np.int32),
                               (np.arange(100) % 10).astype(np.int32)])
    tc = JaxTable.from_arrays("C", [JaxDef("c_id", T.INT32), JaxDef("c_n", T.INT64)],
                              [np.arange(10, dtype=np.int32),
                               np.arange(10, dtype=np.int64) * 7])
    tl = JaxTable.from_arrays("L", [JaxDef("l_oid", T.INT32), JaxDef("l_q", T.INT64)],
                              [np.repeat(np.arange(100), 2).astype(np.int32),
                               np.arange(200, dtype=np.int64)])
    to.column("o_id").unique = True
    tc.column("c_id").unique = True
    return to, tc, tl


def test_unique_survives_a_filter_and_the_probe_side_of_a_lookup_join():
    """Lost on a filtered primary key, every join would fall to the sorted
    path and the direct-address probe would never run."""
    jt = _chain_tables()
    jj1, jj2 = _plan(jax_ops, jax_ast, JaxJoinMode, JaxCond, jt)
    pj1, pj2 = _plan(torch_ops, torch_ast, JoinMode, PredicateCondition,
                     [_port_table(t) for t in jt])
    pout, jout = torch_ops.execute_plan(pj2), jax_ops.execute_plan(jj2)
    assert pj1.path == "lut" and pj2.path == "lut"
    assert jj1.performance_data.extra.get("lookup_join") is True
    assert jj2.performance_data.extra.get("lookup_join") is True
    assert pj1.get_output().live is not None       # masked: probe side untouched
    assert pj1.get_output().column("o_id").unique  # probe-side passthrough
    _assert_same(pout, jout)
    assert pout.num_rows == 100


def test_unique_is_dropped_by_a_gather_that_can_repeat_rows():
    """Kept on a gathered build column, an INNER join would silently drop
    duplicate matches."""
    to, tc, tl = (_port_table(t) for t in _chain_tables())
    # orders joined to lineitem through the sorted path repeats each o_id
    fanned = Join(torch_ops.TableWrapper(to), torch_ops.TableWrapper(tl),
                  JoinMode.INNER, ("o_id", "l_oid"))
    out = torch_ops.execute_plan(fanned)
    assert fanned.path == "ranges" and out.num_rows == 200
    assert not out.column("o_id").unique and not out.column("o_ck").unique
    assert out.column("o_id").val_range == (0, 99)  # a subset keeps its bound
    back = Join(torch_ops.TableWrapper(tc), fanned, JoinMode.INNER, ("c_id", "o_ck"))
    assert torch_ops.execute_plan(back).num_rows == 200 and back.path == "ranges"


def test_metadata_through_sort_alias_projection_and_aggregate():
    to, _, tl = (_port_table(t) for t in _chain_tables())
    A = torch_ast
    src = torch_ops.TableWrapper(to)
    sorted_t = torch_ops.execute_plan(torch_ops.Sort(src, ["o_ck"]))
    assert sorted_t.column("o_id").unique and sorted_t.column("o_id").val_range == (0, 99)
    alias = torch_ops.execute_plan(torch_ops.Alias(src, ["k"], ["o_id"]))
    assert alias.column("k").unique and alias.column("k").val_range == (0, 99)
    proj = torch_ops.execute_plan(torch_ops.Projection(
        src, ["o_id", ("o_ck", A.col("o_ck") + 10)]))
    assert proj.column("o_id").unique
    assert proj.column("o_ck").val_range is None and not proj.column("o_ck").unique
    agg = torch_ops.execute_plan(torch_ops.Aggregate(
        torch_ops.TableWrapper(tl), ["l_oid"], [("n", A.count_())]))
    assert agg.column("l_oid").unique and agg.column("l_oid").val_range == (0, 99)
    two = torch_ops.execute_plan(torch_ops.Aggregate(
        torch_ops.TableWrapper(tl), ["l_oid", "l_q"], []))
    assert not two.column("l_oid").unique


def test_lut_bounds_follow_a_merged_dictionary():
    """Build keys whose merged code exceeds the build column's own
    dictionary must still be found ('zz' sorts past every probe value)."""
    probe = JaxTable.from_arrays("p", [JaxDef("s", T.STRING)],
                                 [np.array(["a", "b", "c", "d", "e"], dtype=object)])
    build = JaxTable.from_arrays("b", [JaxDef("t", T.STRING)],
                                 [np.array(["b", "d", "zz"], dtype=object)])
    for mode, want in (("SEMI", ["b", "d"]), ("ANTI", ["a", "c", "e"])):
        pout, jout, op = _both(probe, build, mode, pair=("s", "t"))
        assert op.path == "lut"
        _assert_same(pout, jout)
        assert [r[0] for r in pout.rows()] == want
    pout, _, _ = _both(build, probe, "SEMI", pair=("t", "s"))
    assert [r[0] for r in pout.rows()] == ["b", "d"]


def test_lut_bounds_are_not_inherited_by_a_derived_column():
    """x + 10 AS x must not carry the base column's val_range: its values
    lie outside it, and a table sized from it would find nothing."""
    jt = JaxTable.from_arrays("t", [JaxDef("x", T.INT64)], [np.arange(8, dtype=np.int64)])
    pt = _port_table(jt)
    assert pt.column("x").val_range == (0, 7)
    A = torch_ast

    def shifted():
        return torch_ops.Projection(torch_ops.TableWrapper(pt),
                                    [("x", A.col("x") + A.lit(10))])
    op = Join(shifted(), shifted(), JoinMode.SEMI, ("x", "x"))
    out = torch_ops.execute_plan(op)
    assert op.path == "lut"  # bounds read from the values themselves
    assert sorted(r[0] for r in out.rows()) == list(range(10, 18))


def test_wide_or_float_keys_take_the_sorted_lookup():
    big = np.array([0, 1 << 40, 5, 1 << 41], dtype=np.int64)
    lt = JaxTable.from_arrays("l", [JaxDef("a", T.INT64)], [big[[0, 1, 2, 1]]])
    rt = JaxTable.from_arrays("r", [JaxDef("b", T.INT64), JaxDef("rv", T.INT32)],
                              [big, np.arange(4, dtype=np.int32)])
    rt.column("b").unique = True
    pout, jout, op = _both(lt, rt, "INNER")
    assert op.path == "lookup"
    _assert_same(pout, jout)


@pytest.mark.parametrize("build_nulls", [False, True])
@pytest.mark.parametrize("build_empty", [False, True])
@pytest.mark.parametrize("kind", ["int_nulls", "int_unique_build"])
def test_not_in_semantics_match_jax(kind, build_empty, build_nulls):
    lt, rt = _tables(kind, seed=8, build_nulls=build_nulls)
    if build_empty:
        rt = _mask(rt, np.zeros(rt.num_rows, dtype=bool))
    for cond in ("EQUALS", "NOT_EQUALS"):   # the lookup path and the sorted path
        pout, jout, _ = _both(lt, rt, "ANTI_NULL_AS_TRUE", cond)
        _assert_same(pout, jout)
    pout, _, _ = _both(lt, rt, "ANTI_NULL_AS_TRUE")
    if build_empty:
        assert pout.num_rows == lt.num_rows       # NOT IN the empty set: all rows
    elif build_nulls:
        assert pout.num_rows == 0                 # a NULL in the set rejects all
    else:
        assert all(r[0] is not None for r in pout.rows())

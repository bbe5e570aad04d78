"""Storage parity between the port (hyrise_tpu_torch) and the JAX package:
TPC-H generation, Column.from_numpy round-trips, and a JAX table carried
across through storage/interop.table_from_numpy."""

import numpy as np
import pytest
import torch

from hyrise_tpu.storage.column import Column as JaxColumn
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)

SF = 0.01
TPCH_TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp",
               "orders", "lineitem"]
_generated = {}


def _both_tpch():
    if not _generated:
        _generated["jax"] = jax_generate_tables(SF)
        _generated["torch"] = generate_tables(SF, device="cpu")
    return _generated["jax"], _generated["torch"]


def export(t: JaxTable):
    """A JAX table as table_from_numpy's arguments (the same bytes,
    padding rows included)."""
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             c.dictionary) for c in t.columns]
    live = None if t.live is None else np.asarray(t.live)
    return cols, t.num_rows, live


@pytest.mark.parametrize("name", TPCH_TABLES)
def test_generate_tables_matches_jax(name):
    jax_tables, port_tables = _both_tpch()
    jt, pt = jax_tables[name], port_tables[name]
    n = jt.num_rows
    assert pt.num_rows == n and pt.capacity == n  # unpadded base tables
    assert pt.column_names == jt.column_names
    for jc, pc in zip(jt.columns, pt.columns):
        assert pc.dtype.value == jc.dtype.value
        assert pc.data.device.type == "cpu"
        assert pc.data.dtype == pc.dtype.torch_dtype
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data)[:n])
        assert (pc.validity is None) == (jc.validity is None)
        if jc.dictionary is None:
            assert pc.dictionary is None
        else:
            np.testing.assert_array_equal(pc.dictionary, jc.dictionary)
        # the metadata that selects and sizes the lookup join
        assert pc.unique == jc.unique
        assert pc.val_range == jc.val_range


def test_primary_keys_are_flagged_unique():
    _, port_tables = _both_tpch()
    flagged = {c.name for t in port_tables.values() for c in t.columns if c.unique}
    assert flagged == {"r_regionkey", "n_nationkey", "s_suppkey", "c_custkey",
                       "p_partkey", "o_orderkey"}
    assert port_tables["lineitem"].column("l_orderkey").val_range[0] == 1
    assert port_tables["lineitem"].column("l_quantity").val_range is None  # float


@pytest.mark.parametrize("case", ["int32_nulls", "int64", "float64", "string", "empty"])
def test_from_numpy_val_range_matches_jax(case):
    dt, values, validity = ROUND_TRIP_CASES[case]
    pc = Column.from_numpy("c", dt, values, validity, device="cpu")
    jc = JaxColumn.from_numpy("c", JaxDataType(dt.value), values, validity)
    assert pc.val_range == jc.val_range and not pc.unique
    renamed = pc.with_name("d")
    assert renamed.val_range == pc.val_range and renamed.unique == pc.unique


def test_table_from_numpy_carries_the_metadata():
    jt = jax_generate_tables(SF)["nation"]
    cols, n, live = export(jt)
    plain = table_from_numpy("nation", cols, n, live, device="cpu")
    assert not plain.column("n_nationkey").unique
    # ranged over the whole array, padding rows included: wider, still a bound
    assert plain.column("n_nationkey").val_range == (0, 24)
    carried = table_from_numpy(
        "nation", cols, n, live, device="cpu",
        unique=[c.name for c in jt.columns if c.unique],
        val_ranges={c.name: c.val_range for c in jt.columns})
    for jc in jt.columns:
        assert carried.column(jc.name).unique == jc.unique
        assert carried.column(jc.name).val_range == jc.val_range


ROUND_TRIP_CASES = {
    "int32_nulls": (DataType.INT32, np.array([3, -1, 7, 0], np.int32),
                    np.array([True, False, True, True])),
    "int64": (DataType.INT64, np.array([2**40, -5, 0], np.int64), None),
    "float32_nulls": (DataType.FLOAT32, np.array([1.5, 2.25, -3.0], np.float32),
                      np.array([False, True, True])),
    "float64": (DataType.FLOAT64, np.array([0.1, 1e300, -2.5]), None),
    "string_nulls": (DataType.STRING,
                     np.array(["pear", None, "apple", "pear", ""], dtype=object), None),
    "string": (DataType.STRING, np.array(["b", "a", "c"], dtype=object), None),
    "empty": (DataType.INT32, np.array([], np.int32), None),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP_CASES))
def test_from_numpy_decode_round_trip(case):
    dtype, values, validity = ROUND_TRIP_CASES[case]
    n = len(values)
    col = Column.from_numpy("c", dtype, values, validity, device="cpu")
    assert col.capacity == n
    jcol = JaxColumn.from_numpy("c", JaxDataType(dtype.value), values, validity)
    got, want = col.decode(n), jcol.decode(n)
    assert list(got) == list(want)
    if dtype is DataType.STRING:
        np.testing.assert_array_equal(col.dictionary, jcol.dictionary)
    # NULLs decode to None wherever the input was NULL
    expect_null = [v is None for v in values] if validity is None else list(~validity)
    assert [v is None for v in got] == expect_null


def test_to_pandas_round_trip():
    from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition

    defs = [TableColumnDefinition("a", DataType.INT32, True),
            TableColumnDefinition("s", DataType.STRING, True),
            TableColumnDefinition("a", DataType.FLOAT64)]
    arrays = [np.array([1, 2, 3], np.int32),
              np.array(["x", None, "y"], dtype=object),
              np.array([0.5, 1.5, 2.5])]
    validities = [np.array([True, True, False]), None, None]
    t = Table.from_arrays("t", defs, arrays, validities, device="cpu")
    df = t.to_pandas()
    assert list(df.columns) == ["a", "s", "a.1"]
    assert list(df["a"]) == [1, 2, None]
    assert list(df["s"].isna()) == [False, True, False]
    assert df["s"][0] == "x" and df["s"][2] == "y"
    assert list(df["a.1"]) == [0.5, 1.5, 2.5]
    assert t.rows() == [(1, "x", 0.5), (2, None, 1.5), (None, "y", 2.5)]


def _jax_table(masked: bool) -> JaxTable:
    from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef

    rng = np.random.default_rng(7)
    n = 50
    strings = np.array(rng.choice(["ant", "bee", "cat", None], n), dtype=object)
    t = JaxTable.from_arrays("t", [
        JaxDef("i", JaxDataType.INT32), JaxDef("f", JaxDataType.FLOAT32, True),
        JaxDef("s", JaxDataType.STRING, True)],
        [rng.integers(-100, 100, n).astype(np.int32),
         rng.random(n).astype(np.float32), strings],
        [None, rng.random(n) < 0.8, None])
    if masked:
        live = np.zeros(t.capacity, dtype=bool)
        live[:n] = rng.random(n) < 0.5
        import jax.numpy as jnp
        t = JaxTable(t.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    return t


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
def test_table_from_numpy_matches_jax_rows(masked):
    jt = _jax_table(masked)
    cols, num_rows, live = export(jt)
    pt = table_from_numpy("t", cols, num_rows, live, device="cpu")
    assert pt.capacity == jt.capacity and pt.num_rows == jt.num_rows
    assert pt.is_prefix == (not masked)
    assert pt.rows() == jt.rows()

"""The port's TPC-C generator (hyrise_tpu_torch/tpcc/generator.py) against
the JAX package's (hyrise_tpu/tpcc/generator.py): for one seed and warehouse
count, every table has the same rows and every column the same type,
values, NULLs and dictionary."""

import numpy as np
import pytest

from hyrise_tpu.tpcc.generator import generate_tpcc_tables as jax_generate_tpcc_tables
from hyrise_tpu_torch.tpcc.generator import generate_tpcc_tables

TABLES = ("item", "warehouse", "district", "customer", "history", "stock",
          "tpcc_order", "order_line", "new_order")
_state = {}


def generated(warehouses, seed):
    key = (warehouses, seed)
    if key not in _state:
        _state[key] = (generate_tpcc_tables(warehouses, seed, device="cpu"),
                       jax_generate_tpcc_tables(warehouses, seed))
    return _state[key]


def assert_same_table(t, jt):
    assert t.num_rows == jt.num_rows
    assert t.column_names == jt.column_names
    for c, jc in zip(t.columns, jt.columns):
        assert c.dtype.value == jc.dtype.value, c.name
        assert c.device.type == "cpu"
        got, want = c.decode(t.num_rows), jc.decode(jt.num_rows)
        if c.dictionary is not None or jc.dictionary is not None:
            assert list(c.dictionary) == list(jc.dictionary), c.name
        assert got.dtype == want.dtype, c.name
        np.testing.assert_array_equal(got, want, err_msg=c.name)


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_jax(name):
    tables, jax_tables = generated(1, 42)
    assert sorted(tables) == sorted(jax_tables) == sorted(TABLES)
    assert_same_table(tables[name], jax_tables[name])


def test_cardinalities():
    tables, _ = generated(1, 42)
    rows = {name: t.num_rows for name, t in tables.items()}
    assert rows["item"] == 100_000 and rows["warehouse"] == 1
    assert rows["district"] == 10 and rows["customer"] == 30_000
    assert rows["stock"] == 100_000 and rows["tpcc_order"] == 30_000
    assert rows["new_order"] == 9_000
    assert 5 * 30_000 <= rows["order_line"] <= 15 * 30_000


def test_another_seed_and_two_warehouses_equal_jax():
    tables, jax_tables = generated(2, 7)
    for name in TABLES:
        assert_same_table(tables[name], jax_tables[name])
    assert tables["warehouse"].num_rows == 2
    assert tables["stock"].num_rows == 200_000

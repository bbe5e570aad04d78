"""The port's copies of the two host-only test helpers
(hyrise_tpu_torch/utils/sqlite_oracle.py and table_eq.py) against the JAX
package's: the same verdicts from tables_equal, and the same answers from a
sqlite database loaded from the same generated tables."""

import pytest
import torch

from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.utils import sqlite_oracle as jax_oracle
from hyrise_tpu.utils import table_eq as jax_eq
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_SQL
from hyrise_tpu_torch.utils import sqlite_oracle, table_eq

torch.set_num_threads(1)

BASE = [(1, "a", 1.5, None), (2, "b", 2.5, 7), (3, None, float("nan"), 8)]
EQ_CASES = {
    "identical": (BASE, BASE, {}),
    "reordered_unordered": (BASE[::-1], BASE, {"ordered": False}),
    "reordered_ordered": (BASE[::-1], BASE, {"ordered": True}),
    "float_within_rel_tol": ([(1, 100.00001)], [(1, 100.0)], {"rel_tol": 1e-6}),
    "float_outside_rel_tol": ([(1, 100.01)], [(1, 100.0)], {"rel_tol": 1e-6}),
    "int_vs_float_lenient": ([(1, 2)], [(1, 2.0)], {}),
    "null_vs_value": ([(1, None)], [(1, 0)], {}),
    "string_vs_int": ([("1",)], [(1,)], {}),
    "row_count": (BASE, BASE[:2], {}),
    "column_count": ([(1, 2)], [(1,)], {}),
    "abs_tol_near_zero": ([(0.0000001,)], [(0.0,)], {"abs_tol": 1e-6}),
    "nan_equals_nan": ([(float("nan"),)], [(float("nan"),)], {}),
}


@pytest.mark.parametrize("name", sorted(EQ_CASES))
def test_tables_equal_matches_jax_copy(name):
    actual, expected, kwargs = EQ_CASES[name]
    want_ok, want_msg = jax_eq.tables_equal(actual, expected, **kwargs)
    ok, msg = table_eq.tables_equal(actual, expected, **kwargs)
    assert (ok, msg) == (want_ok, want_msg)
    if ok:
        table_eq.assert_tables_equal(actual, expected, **kwargs)
    else:
        with pytest.raises(AssertionError):
            table_eq.assert_tables_equal(actual, expected, **kwargs)


_state = {}


def _oracles():
    if not _state:
        keep = ("nation", "region", "supplier", "customer")
        jt = {k: v for k, v in jax_generate_tables(0.01).items() if k in keep}
        pt = {k: v for k, v in generate_tables(0.01, device="cpu").items() if k in keep}
        _state.update(jax=jax_oracle.SqliteOracle(jt), port=sqlite_oracle.SqliteOracle(pt))
    return _state["jax"], _state["port"]


ORACLE_SQL = {
    "counts": "SELECT count(*), count(DISTINCT c_nationkey) FROM customer",
    "strings_and_floats": "SELECT s_name, s_acctbal, s_phone FROM supplier ORDER BY s_suppkey",
    "join_group": """SELECT r_name, count(*), sum(c_acctbal) FROM customer, nation, region
                     WHERE c_nationkey = n_nationkey AND n_regionkey = r_regionkey
                     GROUP BY r_name ORDER BY r_name""",
    "q22": TPCH_SQL[22].replace("AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey)", ""),
}


@pytest.mark.parametrize("name", sorted(ORACLE_SQL))
def test_sqlite_oracle_matches_jax_copy(name):
    jax_db, port_db = _oracles()
    want, got = jax_db.query(ORACLE_SQL[name]), port_db.query(ORACLE_SQL[name])
    assert len(want) > 0
    assert got == want  # same bytes loaded: equal to the last bit


def test_sqlite_oracle_rejects_a_masked_table():
    from hyrise_tpu_torch.storage.table import Table
    t = generate_tables(0.01, device="cpu")["region"]
    masked = Table(t.columns, 2, name="region",
                   live=torch.tensor([True, False, True, False, False]))
    with pytest.raises(ValueError):
        sqlite_oracle.SqliteOracle({"region": masked})

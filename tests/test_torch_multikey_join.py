"""A join on several column equalities (ROADMAP C22), on the CPU.

The SQL translator keeps one equality of an ON clause or a WHERE clause as
the JoinNode's key and the others as PredicateNodes above it; the LQP text
stays the JAX package's (tests/test_torch_sql_parity.py). The port's
physical translator folds those equalities into one MultiKeyJoin, which
joins on one packed int64 key where the keys' ranges allow. Held against
sqlite, against the plan without the fold, and, where the ranges do not fit,
against the old plan's shape."""

import numpy as np
import pytest
import torch

from hyrise_tpu_torch.ops.join import MultiKeyJoin
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.plan import translator
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpcc.generator import generate_tpcc_tables
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.utils.table_eq import tables_equal

torch.set_num_threads(1)

# order_line with its order on warehouse, district and order id: with one
# warehouse the first key alone pairs every line with every order
THREE_KEYS = ("SELECT o_carrier_id, COUNT(*) AS n, SUM(ol_amount) AS amount, "
              "MAX(ol_number) AS most FROM order_line JOIN tpcc_order "
              "ON ol_w_id = o_w_id AND ol_d_id = o_d_id AND ol_o_id = o_id "
              "WHERE o_carrier_id IS NOT NULL GROUP BY o_carrier_id ORDER BY o_carrier_id")
# the same join, its most selective key first and no aggregate above it, so
# that the plan without the fold can run too
THREE_KEYS_ROWS = ("SELECT ol_o_id, ol_d_id, ol_number, o_c_id, ol_amount "
                   "FROM order_line, tpcc_order "
                   "WHERE ol_o_id = o_id AND ol_d_id = o_d_id AND ol_w_id = o_w_id "
                   "AND ol_number <= 3")
_state = {}


def _tpcc():
    if "cat" not in _state:
        tables = generate_tpcc_tables(1, 42, device="cpu")
        cat = Catalog(device="cpu")
        for name in ("order_line", "tpcc_order"):
            cat.add_table(name, tables[name])
        _state["cat"] = cat
        _state["oracle"] = SqliteOracle({n: tables[n] for n in ("order_line", "tpcc_order")})
    return _state["cat"], _state["oracle"]


def _run(sql, cat):
    p = SQLPipelineBuilder(sql).with_catalog(cat).dont_cache_query_plans().create_pipeline()
    out = p.get_result_table()
    return out, p.pipeline_statements[0].last_plan


def _ops(plan, seen=None):
    seen = set() if seen is None else seen
    if id(plan) in seen:
        return []
    seen.add(id(plan))
    out = [plan]
    for i in plan.inputs:
        out += _ops(i, seen)
    return out


def test_tpcc_three_key_join_matches_sqlite():
    cat, oracle = _tpcc()
    out, plan = _run(THREE_KEYS, cat)
    joins = [o for o in _ops(plan) if isinstance(o, MultiKeyJoin)]
    assert len(joins) == 1 and len(joins[0].column_pairs) == 3
    assert joins[0].performance_data.extra["packed_key"]
    assert out.num_rows > 1
    ok, msg = tables_equal(out.rows(), oracle.query(THREE_KEYS), ordered=True,
                           rel_tol=1e-9, abs_tol=0.0)
    assert ok, msg


def test_fold_keeps_the_row_set(monkeypatch):
    cat, oracle = _tpcc()
    folded, plan = _run(THREE_KEYS_ROWS, cat)
    assert any(isinstance(o, MultiKeyJoin) for o in _ops(plan))
    monkeypatch.setattr(translator, "_fold_join", lambda *a: None)
    unfolded, plan = _run(THREE_KEYS_ROWS, cat)
    assert not any(isinstance(o, MultiKeyJoin) for o in _ops(plan))
    assert sum(isinstance(o, TableScan) for o in _ops(plan)) >= 2
    assert folded.column_names == unfolded.column_names
    assert folded.rows() == unfolded.rows()  # the same rows in the same order
    ok, msg = tables_equal(folded.rows(), oracle.query(THREE_KEYS_ROWS), ordered=False,
                           rel_tol=1e-9, abs_tol=0.0)
    assert ok, msg


def _wide_catalog():
    """Two tables whose three keys span 2^40 values each: 2^120 together."""
    rng = np.random.default_rng(5)
    n = 400
    keys = [rng.integers(0, 3, n) * (1 << 40) + rng.integers(0, 2, n) for _ in range(3)]
    defs = [TableColumnDefinition(c, DataType.INT64) for c in ("a", "b", "c")]
    left = Table.from_arrays("l", defs + [TableColumnDefinition("v", DataType.INT32)],
                             keys + [np.arange(n, dtype=np.int32)], device="cpu")
    order = rng.permutation(n)
    right = Table.from_arrays(
        "r", [TableColumnDefinition(c, DataType.INT64) for c in ("x", "y", "z")]
        + [TableColumnDefinition("w", DataType.INT32)],
        [k[order] for k in keys] + [np.arange(n, dtype=np.int32)], device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("l", left)
    cat.add_table("r", right)
    return cat, {"l": left, "r": right}


@pytest.mark.parametrize("sql", [
    "SELECT v, w FROM l JOIN r ON a = x AND b = y AND c = z",
    "SELECT COUNT(*) AS n, SUM(v) AS s FROM l JOIN r ON a = x AND b = y AND c = z",
])
def test_ranges_that_do_not_fit_keep_the_old_plan(sql):
    cat, tables = _wide_catalog()
    assert tables["l"].column("a").val_range[1] > 1 << 40
    out, plan = _run(sql, cat)
    joins = [o for o in _ops(plan) if isinstance(o, MultiKeyJoin)]
    assert len(joins) == 1 and joins[0].performance_data.extra["packed_key"] is False
    oracle = SqliteOracle(tables)
    ok, msg = tables_equal(out.rows(), oracle.query(sql), ordered=False, rel_tol=1e-9,
                           abs_tol=0.0)
    oracle.close()
    assert ok, msg


def test_string_keys_of_one_dictionary_pack():
    s = np.array(["p", "q", "r"], dtype=object)
    rng = np.random.default_rng(8)
    n = 300
    a = s[rng.integers(0, 3, n)]
    b = rng.integers(0, 50, n).astype(np.int32)
    left = Table.from_arrays("l", [TableColumnDefinition("s", DataType.STRING),
                                   TableColumnDefinition("k", DataType.INT32)], [a, b],
                             device="cpu")
    right = Table.from_arrays("r", [TableColumnDefinition("t", DataType.STRING),
                                    TableColumnDefinition("m", DataType.INT32)],
                              [a[::-1].copy(), b[::-1].copy()], device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("l", left)
    cat.add_table("r", right)
    sql = "SELECT s, k, COUNT(*) AS n FROM l JOIN r ON s = t AND k = m GROUP BY s, k ORDER BY s, k"
    out, plan = _run(sql, cat)
    (join,) = [o for o in _ops(plan) if isinstance(o, MultiKeyJoin)]
    assert join.performance_data.extra["packed_key"]
    oracle = SqliteOracle({"l": left, "r": right})
    ok, msg = tables_equal(out.rows(), oracle.query(sql), ordered=True, rel_tol=0.0,
                           abs_tol=0.0)
    oracle.close()
    assert ok, msg

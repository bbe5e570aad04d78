"""All 22 TPC-H queries end to end: the port's operator DAGs
(hyrise_tpu_torch.tpch.queries) against the JAX package's plans on the same
generated data, and against the sqlite oracle, at the scale factors of
tests/test_tpch.py (SF 0.01; Q20 at 0.05 so that it returns rows). Integers
and strings must match exactly, floats within 1e-6 relative
(ARCHITECTURE.md's float policy), rows in the same order."""

import pytest
import torch

from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu.utils.table_eq import assert_tables_equal
from hyrise_tpu_torch.kernels import prims
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, run_query

torch.set_num_threads(1)

SF = 0.01
QUERY_SF = {20: 0.05}
# queries whose ORDER BY leaves ties (or that have none): sqlite may break
# them differently, so they are compared with sqlite as row sets. Against the
# JAX plans every query is compared in order: both sorts are stable over the
# same row order.
SQLITE_UNORDERED = {2, 3, 10, 13, 16, 18, 21}
_state = {}


def _setup(sf):
    if sf not in _state:
        jax_tables = jax_generate_tables(sf)
        jcat = JaxCatalog()
        for name, t in jax_tables.items():
            jcat.add_table(name, t)
        cat = Catalog()
        for name, t in generate_tables(sf, device="cpu").items():
            cat.add_table(name, t)
        oracle = SqliteOracle(jax_tables)
        # indexes keep the oracle's correlated subqueries fast
        for ddl in ["CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                    "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
                    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                    "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
                    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"]:
            oracle.conn.execute(ddl)
        _state[sf] = (jcat, cat, oracle)
    return _state[sf]


def test_all_22_plans_are_ported():
    assert sorted(TPCH_PLANS) == sorted(JAX_PLANS) == list(range(1, 23))
    assert sorted(TPCH_SQL) == list(range(1, 23))


@pytest.mark.parametrize("qid", sorted(JAX_PLANS))
def test_query_matches_jax(qid):
    jcat, cat, _ = _setup(QUERY_SF.get(qid, SF))
    got = run_query(qid, cat)
    want = jax_execute_plan(JAX_PLANS[qid](jcat))
    assert got.column_names == want.column_names
    if qid != 2:  # Q2's double equality on price can be empty at a tiny SF
        assert got.num_rows > 0
    assert_tables_equal(got.rows(), want.rows(), ordered=True, rel_tol=1e-6,
                        abs_tol=0.0)


@pytest.mark.parametrize("qid", sorted(JAX_PLANS))
def test_query_matches_sqlite(qid):
    _, cat, oracle = _setup(QUERY_SF.get(qid, SF))
    got = run_query(qid, cat).rows()
    want = oracle.query(TPCH_SQL[qid])
    if qid != 2:
        assert len(want) > 0
    assert_tables_equal(got, want, ordered=qid not in SQLITE_UNORDERED,
                        rel_tol=1e-6, abs_tol=0.0)


def _joins(op, seen=None):
    seen = {} if seen is None else seen
    if id(op) not in seen:
        seen[id(op)] = op
        for i in op.inputs:
            _joins(i, seen)
    return [o for o in seen.values() if isinstance(o, Join)]


@pytest.mark.parametrize("qid,paths", [
    (3, {"lut"}), (5, {"lut"}), (9, {"lut", "ranges"}), (13, {"lut"}),
    (15, {"ranges"}), (16, {"lut"}), (20, {"lut", "lookup"})])
def test_joins_take_the_expected_paths(qid, paths):
    """Primary keys keep their `unique` flag through filters, so their joins
    take the direct-address lookup; composite and float keys do not."""
    _, cat, _ = _setup(QUERY_SF.get(qid, SF))
    plan = TPCH_PLANS[qid](cat)
    execute_plan(plan)
    assert {j.path for j in _joins(plan)} == paths


def test_cpu_tensors_launch_no_kernel():
    _, cat, _ = _setup(SF)
    before = (prims.segment_reduce_cells.launches, prims.lookup_last_eq_lut.launches,
              prims.expand_pairs.launches)
    run_query(9, cat)
    assert before == (prims.segment_reduce_cells.launches,
                      prims.lookup_last_eq_lut.launches, prims.expand_pairs.launches)


def test_unported_query_raises():
    _, cat, _ = _setup(SF)
    with pytest.raises(NotImplementedError):
        run_query(23, cat)

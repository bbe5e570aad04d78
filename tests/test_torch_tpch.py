"""TPC-H Q1 and Q6 end to end at SF 0.01: the port's operator DAGs
(hyrise_tpu_torch.tpch.queries) against the JAX package's on the same
generated data, and against the sqlite oracle. Integers and strings must
match exactly, floats within 1e-6 relative (ARCHITECTURE.md's float
policy)."""

import pytest
import torch

from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu.utils.table_eq import assert_tables_equal
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_SQL, run_query

torch.set_num_threads(1)

SF = 0.01
_state = {}


def _setup():
    if not _state:
        jax_tables = jax_generate_tables(SF)
        jcat = JaxCatalog()
        for name, t in jax_tables.items():
            jcat.add_table(name, t)
        cat = Catalog()
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        lineitem = {"lineitem": jax_tables["lineitem"]}
        _state.update(jcat=jcat, cat=cat, oracle=SqliteOracle(lineitem))
    return _state["jcat"], _state["cat"], _state["oracle"]


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_query_matches_jax(qid):
    jcat, cat, _ = _setup()
    got = run_query(qid, cat).rows()
    want = jax_execute_plan(JAX_PLANS[qid](jcat)).rows()
    assert len(got) > 0
    assert_tables_equal(got, want, ordered=True, rel_tol=1e-6, abs_tol=0.0)


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_query_matches_sqlite(qid):
    _, cat, oracle = _setup()
    got = run_query(qid, cat).rows()
    want = oracle.query(TPCH_SQL[qid])
    assert len(want) > 0
    assert_tables_equal(got, want, ordered=True, rel_tol=1e-6, abs_tol=0.0)


def test_unported_query_raises():
    _, cat, _ = _setup()
    with pytest.raises(NotImplementedError):
        run_query(3, cat)

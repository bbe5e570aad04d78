"""All 22 TPC-H queries through the port's whole-plan compiled execution
(hyrise_tpu_torch/plan/compiler.py): the hand plans through
run_query(via="compiled") and the SQL texts through
SQLPipelineBuilder.with_compiled_execution(), at the scale factors of
tests/test_tpch_compiled.py (SF 0.01; Q20 at 0.05). Each is held against the
port's eager answer (rows in order), the JAX package's CompiledQuery over the
same generated data (rows in order) and the sqlite oracle; integers and
strings exact, floats within 1e-6 relative. No JAX compiled answer at these
scale factors meets a known reference fault (ROADMAP C1, C4, C5, C23), so
every query is held against all three. On CPU tensors the capacity mode runs
without a CUDA graph; a second run must retry nothing and read no count
eagerly."""

import pytest
import torch

from hyrise_tpu.plan.compiler import CompiledQuery as JaxCompiledQuery
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.utils.sqlite_oracle import SqliteOracle
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.plan import compiler
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL, compiled_query, run_query
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

SF = 0.01
QUERY_SF = {20: 0.05}
# ORDER BY ties (or no ORDER BY): sqlite may break them differently, so it
# is compared as row sets (as in tests/test_torch_tpch.py)
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
        for ddl in ["CREATE INDEX idx_l_ok ON lineitem(l_orderkey)",
                    "CREATE INDEX idx_l_pk ON lineitem(l_partkey)",
                    "CREATE INDEX idx_l_ps ON lineitem(l_partkey, l_suppkey)",
                    "CREATE INDEX idx_o_ck ON orders(o_custkey)",
                    "CREATE INDEX idx_o_ok ON orders(o_orderkey)",
                    "CREATE INDEX idx_ps_pk ON partsupp(ps_partkey)"]:
            oracle.conn.execute(ddl)
        _state[sf] = (jcat, cat, oracle)
    return _state[sf]


def _against_sqlite(qid, rows, oracle):
    assert_tables_equal(rows, oracle.query(TPCH_SQL[qid]), ordered=qid not in SQLITE_UNORDERED,
                        rel_tol=1e-6, abs_tol=0.0)


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_hand_plan_compiled(qid):
    jcat, cat, oracle = _setup(QUERY_SF.get(qid, SF))
    got = run_query(qid, cat, via="compiled")
    eager = execute_plan(TPCH_PLANS[qid](cat))
    assert got.column_names == eager.column_names
    assert got.device.type == "cpu"
    rows = got.rows()
    assert_tables_equal(rows, eager.rows(), ordered=True, rel_tol=1e-6, abs_tol=0.0)
    want = JaxCompiledQuery(JAX_PLANS[qid](jcat), jcat).run().rows()
    assert_tables_equal(rows, want, ordered=True, rel_tol=1e-6, abs_tol=0.0)
    _against_sqlite(qid, rows, oracle)
    # the second run keeps the learned capacities: no retry, no eager read
    reads = compiler.eager_reads()
    again = run_query(qid, cat, via="compiled").rows()
    assert compiler.eager_reads() == reads
    assert compiled_query(qid, cat).last_retries == 0
    assert_tables_equal(again, rows, ordered=True, rel_tol=0.0, abs_tol=0.0)


@pytest.mark.parametrize("qid", sorted(TPCH_SQL))
def test_sql_text_compiled(qid):
    _, cat, oracle = _setup(QUERY_SF.get(qid, SF))
    eager = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat).create_pipeline() \
        .get_result_table().rows()
    for _ in range(2):  # compiled, then the cached CompiledQuery
        pipeline = SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat) \
            .with_compiled_execution().create_pipeline()
        rows = pipeline.get_result_table().rows()
        assert pipeline.pipeline_statements[-1].last_compiled
        assert_tables_equal(rows, eager, ordered=True, rel_tol=1e-6, abs_tol=0.0)
        _against_sqlite(qid, rows, oracle)

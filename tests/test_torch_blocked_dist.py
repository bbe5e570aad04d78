"""Blocked streaming over sharded tables
(hyrise_tpu_torch/parallel/blocked_dist.py), after tests/test_blocked_dist.py.

TPC-H at SF 0.02 over 8 in-process CPU shards; lineitem streams in blocks
of a quarter of its largest shard. Q1, Q3 and Q6 equal the single-node
plans (floats within 1e-6 relative), twice, and the JAX
BlockedDistributedQuery on the 8-device CPU mesh over the same tables and
block size; the operators off the stream path run once a run; a plan that
reads the stream table twice, and a UnionAll on the stream path (ROADMAP
C1, which the JAX package accepts), are refused."""

import pytest
import torch

from hyrise_tpu.parallel.blocked_dist import BlockedDistributedQuery as JBlockedDistributedQuery
from hyrise_tpu.parallel.dist_compiler import shard_tpch as jax_shard_tpch
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.misc import UnionAll
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.parallel.blocked_dist import BlockedDistributedQuery
from hyrise_tpu_torch.parallel.dist_compiler import shard_tpch
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.plan.blocked import PlanNotCompilable
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

N = 8
SF = 0.02
_state = {}


def _env():
    if not _state:
        cat = Catalog(device="cpu")
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        _state.update(cat=cat, sc=shard_tpch(cat, make_mesh(N, device="cpu")))
    return _state


def _jax_env():
    if "jcat" not in _state:
        jcat = JCatalog()
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        _state.update(jcat=jcat, jsc=jax_shard_tpch(jcat, jax_make_mesh(N)))
    return _state["jcat"], _state["jsc"]


@pytest.mark.parametrize("qid", [1, 3, 6])
def test_blocked_distributed_equals_the_jax_blocked_query(qid):
    """The JAX form needs a block that divides its padded shard capacity:
    both packages stream lineitem in a quarter of it."""
    e = _env()
    jcat, jsc = _jax_env()
    block = jsc.get("lineitem").shard_capacity // 4
    jbq = JBlockedDistributedQuery(JAX_PLANS[qid](jcat), jsc, block_rows=block)
    want = jbq.run()
    bq = BlockedDistributedQuery(TPCH_PLANS[qid](e["cat"]), e["sc"], block_rows=block)
    got = bq.run()
    assert bq.n_blocks == jbq.n_blocks >= 2
    assert got.column_names == want.column_names
    assert_tables_equal(got.rows(), want.rows(), ordered=True, rel_tol=1e-6)


@pytest.mark.parametrize("qid", [1, 3, 6])
def test_blocked_distributed_equals_single_node(qid):
    e = _env()
    ref = execute_plan(TPCH_PLANS[qid](e["cat"]))
    block = int(e["sc"].get("lineitem").counts.max()) // 4 + 1
    bq = BlockedDistributedQuery(TPCH_PLANS[qid](e["cat"]), e["sc"], block_rows=block)
    assert bq.n_blocks == 4 and bq._stream.name == "lineitem"
    got = bq.run()
    assert got.column_names == ref.column_names
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=1e-6)
    assert_tables_equal(bq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-6)


def test_off_path_exchanges_run_once_a_run():
    """Q3's customer and orders sides sit off lineitem's path: their
    exchanges are counted once, though lineitem streams in 4 blocks."""
    e = _env()
    block = int(e["sc"].get("lineitem").counts.max()) // 4 + 1
    bq = BlockedDistributedQuery(TPCH_PLANS[3](e["cat"]), e["sc"], block_rows=block)
    bq.run()
    per_block = [label for label, _ in bq._sites]
    assert per_block.count("exchange.gather") == 1 + bq.n_blocks  # customer once, partials
    assert bq.op_rows[id(bq._leaf)] == [
        max(min(int(c) - 3 * block, block), 0) for c in e["sc"].get("lineitem").counts]


def test_blocked_distributed_refuses_two_references_to_the_stream():
    e = _env()
    with pytest.raises(PlanNotCompilable):
        BlockedDistributedQuery(TPCH_PLANS[18](e["cat"]), e["sc"], stream_table="lineitem",
                                block_rows=512)


def test_blocked_distributed_refuses_a_union_all_on_the_stream_path():
    """ROADMAP C1: the JAX package streams through a UnionAll and counts its
    other input once per block; the port refuses the plan."""
    e = _env()
    two = Table([Column("l_quantity", DataType.FLOAT32, torch.ones(2))], 2, name="two")

    def plan():
        union = UnionAll(Projection(GetTable("lineitem", e["cat"]), ["l_quantity"]),
                         TableWrapper(two))
        return Aggregate(union, [], [("n", ast.count_())])

    with pytest.raises(PlanNotCompilable):
        BlockedDistributedQuery(plan(), e["sc"], block_rows=1000)
    with pytest.raises(PlanNotCompilable):
        BlockedDistributedQuery(TPCH_PLANS[2](e["cat"]), e["sc"], block_rows=1000)  # a Sort root

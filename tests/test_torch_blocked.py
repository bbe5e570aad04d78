"""Blocked streaming execution (hyrise_tpu_torch/plan/blocked.py), the
block view of a table (Table.block) and the build cache of a streamed join
(ops/join.py BuildCache), on the CPU.

The cases of tests/test_blocked.py that do not concern compilation, with
the JAX package's eager engine as the oracle on the same numpy-seeded
TPC-H at SF 0.02 (ints and strings exactly, floats within 1e-6 relative),
plus what the port's eager form adds: a partial last block, empty blocks,
a Validate over sliced MVCC vectors, and ROADMAP C1's shape (a UnionAll on
the stream path), which the port refuses where the JAX package counts the
union's other input once per block."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.storage.catalog import Catalog as JaxCatalog
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join, MultiKeyJoin
from hyrise_tpu_torch.ops.misc import Limit, UnionAll
from hyrise_tpu_torch.ops.rw_ops import Validate
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.plan.blocked import BlockedQuery, PlanNotCompilable
from hyrise_tpu_torch.sql.pipeline import run_sql
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.encoding import ChunkEncoder, EncodingType, FOR_BLOCK
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, run_query
from hyrise_tpu_torch.types import DataType, JoinMode, SortMode
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

SF = 0.02
_state = {}


def _catalogs():
    if not _state:
        jcat = JaxCatalog()
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        cat = Catalog(device="cpu")
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        _state.update(jcat=jcat, cat=cat)
    return _state["jcat"], _state["cat"]


def _table(name, df) -> Table:
    defs, arrays = [], []
    for c in df.columns:
        arr = df[c].to_numpy()
        dt = DataType.STRING if arr.dtype == object else {
            np.dtype(np.int32): DataType.INT32, np.dtype(np.int64): DataType.INT64,
            np.dtype(np.float64): DataType.FLOAT64}[arr.dtype]
        defs.append(TableColumnDefinition(c, dt))
        arrays.append(arr)
    return Table.from_arrays(name, defs, arrays, device="cpu")


def _catalog(**tables) -> Catalog:
    cat = Catalog(device="cpu")
    for name, df in tables.items():
        cat.add_table(name, _table(name, df))
    return cat


def _walk(root, seen=None):
    seen = set() if seen is None else seen
    if id(root) in seen:
        return []
    seen.add(id(root))
    out = [root]
    for i in root.inputs:
        out += _walk(i, seen)
    return out


# -- TPC-H against the JAX package's eager engine ------------------------------


@pytest.mark.parametrize("qid", [1, 3, 6, 14])
def test_blocked_matches_jax_eager(qid):
    jcat, cat = _catalogs()
    want = jax_execute_plan(JAX_PLANS[qid](jcat)).rows()
    rows = cat.get_table("lineitem").num_rows
    block = 1 << 15  # several blocks, the last one partial
    assert rows % block
    bq = BlockedQuery(TPCH_PLANS[qid](cat), cat, block_rows=block)
    assert bq.n_blocks == 4
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-6)
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-6)
    assert_tables_equal(run_query(qid, cat, via="blocked", block_rows=block).rows(), want,
                        ordered=True, rel_tol=1e-6)


def test_blocked_rejects_self_join():
    _, cat = _catalogs()
    # Q18 references lineitem twice (the HAVING subquery's self-join)
    with pytest.raises(PlanNotCompilable, match="referenced 2 times"):
        BlockedQuery(TPCH_PLANS[18](cat), cat, stream_table="lineitem", block_rows=1 << 14)


def test_blocked_rejects_no_aggregate():
    _, cat = _catalogs()
    with pytest.raises(PlanNotCompilable, match="top-level Aggregate"):
        BlockedQuery(TPCH_PLANS[2](cat), cat, block_rows=1 << 14)


@pytest.mark.parametrize("qid,what", [(4, "semi build"), (13, "left build, nested"),
                                      (22, "anti build")])
def test_blocked_rejects_a_stream_on_a_build_side(qid, what):
    """Q4: lineitem on the build side of a semi join (an order with lines in
    two blocks would pass twice); Q13: orders on the build side of a LEFT
    join under a nested aggregate; Q22: orders on the build side of an anti
    join (a customer with no order in SOME block would pass)."""
    _, cat = _catalogs()
    with pytest.raises(PlanNotCompilable, match="not row-distributive"):
        BlockedQuery(TPCH_PLANS[qid](cat), cat, block_rows=1 << 14)


def test_blocked_run_leaves_plan_intact():
    """The run grafts its merge onto the tail and rewires the stream leaf;
    afterwards the caller's plan is the same objects with no outputs, and it
    executes to the same rows."""
    _, cat = _catalogs()
    plan = TPCH_PLANS[1](cat)
    before = [(op, list(op.inputs)) for op in _walk(plan)]
    out = BlockedQuery(plan, cat, block_rows=1 << 14).run()
    assert [(op, list(op.inputs)) for op in _walk(plan)] == before
    assert all(op.get_output() is None for op in _walk(plan))
    assert_tables_equal(out.rows(), execute_plan(plan).rows(), ordered=True, rel_tol=1e-6)


# -- small shapes ----------------------------------------------------------------


def test_blocked_avg_over_integer_column():
    """AVG decomposes into SUM and COUNT; over an integer column the finish
    must divide as FLOAT64 (1.5, not 1)."""
    cat = _catalog(t=pd.DataFrame({"g": np.repeat(np.arange(4, dtype=np.int64), 4),
                                   "v": np.arange(16, dtype=np.int64)}))

    def plan():
        return Aggregate(GetTable("t", cat), ["g"],
                         [("a", ast.avg_(ast.col("v"))), ("q", ast.avg_(ast.col("g")))])

    want = execute_plan(plan()).to_pandas().sort_values("g")
    bq = BlockedQuery(plan(), cat, block_rows=8)
    got = bq.run().to_pandas().sort_values("g")
    assert bq.n_blocks == 2
    assert got["a"].tolist() == [1.5, 5.5, 9.5, 13.5] == want["a"].tolist()
    assert got["q"].tolist() == want["q"].tolist()


def test_blocked_topk_limit_sort_root():
    """A Limit(Sort(..)) root streams without an aggregate: a top K per
    block, then one sort of the K x n_blocks rows."""
    rng = np.random.default_rng(4)
    n = 5000
    cat = _catalog(t=pd.DataFrame({"a": rng.integers(0, 1000, n).astype(np.int64),
                                   "v": rng.normal(size=n)}))

    def plan():
        return Limit(Sort(TableScan(GetTable("t", cat), ast.col("a") < ast.lit(500)),
                          [("v", SortMode.DESCENDING), "a"]), 25)

    want = execute_plan(plan()).rows()
    bq = BlockedQuery(plan(), cat, block_rows=2048)
    assert bq._mode == "topk" and bq.n_blocks == 3
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=0.0)
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=0.0)


def test_blocked_rejects_nested_aggregate_on_path():
    rng = np.random.default_rng(3)
    n = 4096
    cat = _catalog(big=pd.DataFrame({"g": rng.integers(0, 7, n).astype(np.int64),
                                     "v": rng.random(n)}))
    inner = Aggregate(GetTable("big", cat), ["g"], [("s", ast.sum_(ast.col("v")))])
    outer = Aggregate(inner, [], [("m", ast.max_(ast.col("s")))])
    with pytest.raises(PlanNotCompilable, match="not row-distributive"):
        BlockedQuery(outer, cat, block_rows=1024)


def _semi_catalog():
    rng = np.random.default_rng(11)
    n = 4096
    return _catalog(big=pd.DataFrame({"k": rng.integers(0, 200, n).astype(np.int64),
                                      "g": rng.integers(0, 5, n).astype(np.int64),
                                      "v": rng.random(n)}),
                    dim=pd.DataFrame({"dk": np.arange(0, 200, 3, dtype=np.int64)}))


def test_blocked_accepts_semi_probe_stream():
    """The stream table on the preserved side of a semi join: each of its
    rows passes or not whatever the blocks are."""
    cat = _semi_catalog()

    def plan():
        semi = Join(GetTable("big", cat), GetTable("dim", cat), JoinMode.SEMI, ("k", "dk"))
        return Sort(Aggregate(semi, ["g"], [("s", ast.sum_(ast.col("v"))),
                                            ("n", ast.count_())]), ["g"])

    want = execute_plan(plan()).rows()
    bq = BlockedQuery(plan(), cat, block_rows=1024)
    assert bq.n_blocks == 4
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)


def test_blocked_having_tail():
    """A TableScan between the root and the Aggregate (HAVING) runs on the
    merged groups."""
    rng = np.random.default_rng(9)
    n = 4000
    cat = _catalog(t=pd.DataFrame({"g": rng.integers(0, 50, n).astype(np.int64),
                                   "v": rng.random(n)}))

    def plan():
        agg = Aggregate(GetTable("t", cat), ["g"], [("s", ast.sum_(ast.col("v")))])
        return Sort(TableScan(agg, ast.col("s") > ast.lit(40.0)), ["g"])

    want = execute_plan(plan()).rows()
    assert want
    bq = BlockedQuery(plan(), cat, block_rows=1024)
    assert bq.n_blocks == 4
    assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)


@pytest.mark.parametrize("dim_unique", [True, False], ids=["lut", "ranges"])
def test_partial_last_block_and_empty_blocks(dim_unique):
    """4,000 rows in blocks of 1,024 (the last one 928 rows); the filter
    leaves the first two blocks empty, so their partial aggregates have no
    group and their joins no probe row, and a global COUNT still merges to
    the eager answer. The join's build side is unique (lookup path) or not
    (sorted ranges)."""
    n = 4000
    keys = np.arange(100, dtype=np.int64) if dim_unique else np.arange(100) % 50
    cat = _catalog(t=pd.DataFrame({"k": (np.arange(n) % 100).astype(np.int64),
                                   "g": np.array(["a", "b", "c", "d"], dtype=object)[
                                       np.arange(n) % 4],
                                   "v": np.arange(n, dtype=np.float64)}),
                   d=pd.DataFrame({"dk": keys.astype(np.int64),
                                   "w": np.arange(100, dtype=np.int64)}))
    if dim_unique:
        cat.get_table("d").column("dk").unique = True

    def plans():
        kept = TableScan(GetTable("t", cat), ast.col("v") >= ast.lit(2048.0))
        joined = Join(kept, GetTable("d", cat), JoinMode.INNER, ("k", "dk"))
        grouped = Sort(Aggregate(joined, ["g"], [("s", ast.sum_(ast.col("v"))),
                                                 ("m", ast.min_(ast.col("w"))),
                                                 ("n", ast.count_())]), ["g"])
        total = Aggregate(TableScan(GetTable("t", cat), ast.col("v") < ast.lit(0.0)), [],
                          [("n", ast.count_()), ("s", ast.sum_(ast.col("v")))])
        return grouped, total

    for plan, want in zip(plans(), [execute_plan(p).rows() for p in plans()]):
        bq = BlockedQuery(plan, cat, block_rows=1024)
        assert bq.n_blocks == 4
        assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)


def test_a_rewritten_dictionary_in_every_block_keeps_one_group():
    """SUBSTR rewrites the dictionary on the host in every block, so each
    block's partials carry a dictionary object of their own with equal
    content: the final aggregate must still give one group a value."""
    n = 3000
    words = np.array(["apple", "apricot", "banana", "blueberry", "cherry"], dtype=object)
    cat = _catalog(t=pd.DataFrame({"s": words[np.arange(n) % 5],
                                   "v": np.arange(n, dtype=np.int64)}))

    def plan():
        from hyrise_tpu_torch.ops.projection import Projection
        first = Projection(GetTable("t", cat), [("f", ast.col("s").substr(1, 1)), "v"])
        return Sort(Aggregate(first, ["f"], [("n", ast.count_()),
                                             ("s", ast.sum_(ast.col("v")))]), ["f"])

    want = execute_plan(plan()).rows()
    assert [r[0] for r in want] == ["a", "b", "c"]
    bq = BlockedQuery(plan(), cat, block_rows=1000)
    assert bq.n_blocks == 3
    assert bq.run().rows() == want


def test_union_on_the_stream_path_is_refused():
    """ROADMAP C1: an Aggregate over UnionAll(4,096-row stream, 2-row
    table). The JAX package accepts it and counts the 2 rows once per block
    (4,104 for 4,098); the port refuses it, and the eager answer is 4,098."""
    cat = _catalog(big=pd.DataFrame({"v": np.ones(4096)}),
                   small=pd.DataFrame({"v": np.ones(2)}))

    def plan():
        return Aggregate(UnionAll(GetTable("big", cat), GetTable("small", cat)), [],
                         [("n", ast.count_()), ("s", ast.sum_(ast.col("v")))])

    assert execute_plan(plan()).rows() == [(4098, 4098.0)]
    with pytest.raises(PlanNotCompilable, match="UnionAll on the stream path"):
        BlockedQuery(plan(), cat, block_rows=1024)


def test_mvcc_deleted_row_in_the_last_block():
    """A streamed plan with a Validate over the stream table: the block's
    sliced MVCC vectors hide a row deleted in the last block, as the whole
    table's do."""
    n = 3000
    t = _table("t", pd.DataFrame({"a": np.arange(n, dtype=np.int64),
                                  "g": (np.arange(n) % 3).astype(np.int64)}))
    t.mvcc = MvccData.for_new_table(n, n, device="cpu")
    cat = Catalog(device="cpu")
    cat.add_table("t", t)
    run_sql("DELETE FROM t WHERE a = 2999", cat, use_mvcc=True)

    def plan():
        return Sort(Aggregate(Validate(GetTable("t", cat)), ["g"],
                              [("n", ast.count_()), ("s", ast.sum_(ast.col("a")))]), ["g"])

    context = cat.transaction_manager.new_transaction_context()
    want = execute_plan(plan(), context).rows()
    assert sum(r[1] for r in want) == n - 1
    bq = BlockedQuery(plan(), cat, block_rows=1024)
    assert bq.n_blocks == 3
    assert bq.run(context).rows() == want


# -- the block view ----------------------------------------------------------------


def test_block_shares_storage():
    n = 5000
    rng = np.random.default_rng(2)
    t = Table([Column.from_numpy("k", DataType.INT64, np.arange(n, dtype=np.int64),
                                 device="cpu"),
               Column.from_numpy("s", DataType.STRING,
                                 np.array(["x", "y", None], dtype=object)[np.arange(n) % 3],
                                 device="cpu"),
               Column.from_numpy("f", DataType.FLOAT64, rng.random(n), device="cpu")],
              n, name="t")
    t.columns[0].unique = True
    t.mvcc = MvccData.for_new_table(n, n + 100, device="cpu")
    b = t.block(1000, 3000)
    assert b.num_rows == 2000 and b.capacity == 2000 and b.name == "t"
    for whole, part in zip(t.columns, b.columns):
        size = whole.data.element_size()
        assert part.data.data_ptr() == whole.data.data_ptr() + 1000 * size
        assert part.dictionary is whole.dictionary
        assert part.unique == whole.unique and part.val_range == whole.val_range
        assert torch.equal(part.data, whole.data[1000:3000])
    k, s = b.column("k"), b.column("s")
    assert k.unique and k.val_range == (0, n - 1)
    assert s.validity.data_ptr() == t.column("s").validity.data_ptr() + 1000
    for name in ("tids", "begin_cids", "end_cids"):
        whole, part = getattr(t.mvcc, name), getattr(b.mvcc, name)
        assert part.data_ptr() == whole.data_ptr() + 1000 * 8 and part.shape == (2000,)
    assert b.mvcc.write_lock is t.mvcc.write_lock
    assert b.block_stats is None and b.indexes == {}
    # past the live rows: a prefix block keeps only the rows below num_rows
    t.num_rows = 2500
    assert t.block(2000, 3000).num_rows == 500 and t.block(2600, 3000).num_rows == 0


@pytest.mark.parametrize("encoding", ["DICTIONARY", "FRAME_OF_REFERENCE", "RUN_LENGTH"])
def test_block_of_encoded_columns(encoding):
    """DICTIONARY blocks view the narrowed codes, FRAME_OF_REFERENCE blocks
    that start on a frame view its frames and offsets; others decode the
    slice. Every block decodes to the rows of the whole column."""
    n = 3 * FOR_BLOCK + 77
    rng = np.random.default_rng(6)
    dense = Table([Column.from_numpy("v", DataType.INT64, rng.integers(0, 300, n),
                                     device="cpu"),
                   Column.from_numpy("s", DataType.STRING,
                                     np.array(["p", "q"], dtype=object)[np.arange(n) % 2],
                                     device="cpu")], n, name="t")
    t = ChunkEncoder.encode_table(dense, EncodingType[encoding])
    for lo, hi in ((FOR_BLOCK, 3 * FOR_BLOCK), (2 * FOR_BLOCK, n), (5, 2 * FOR_BLOCK + 9)):
        b = t.block(lo, hi)
        for whole, part, ref in zip(t.columns, b.columns, dense.columns):
            assert torch.equal(part.data, ref.data[lo:hi])
            assert part.val_range == whole.val_range
            payload = part.encoded
            if encoding == "DICTIONARY":
                assert payload.codes.data_ptr() == whole.encoded.codes.data_ptr() + \
                    lo * payload.codes.element_size()
            elif encoding == "FRAME_OF_REFERENCE" and lo % FOR_BLOCK == 0 and \
                    whole.encoded is not None:
                assert payload.offsets.data_ptr() == whole.encoded.offsets.data_ptr() + \
                    lo * payload.offsets.element_size()
            else:
                assert payload is None


# -- the build cache -----------------------------------------------------------------


@pytest.mark.parametrize("unique,path", [(True, "lut"), (False, "ranges")])
def test_streamed_join_builds_once_a_run(unique, path):
    """A join whose build input is off the stream path builds its side once
    a run, not once a block (BuildCache.builds), and the cache is gone after
    the run."""
    rng = np.random.default_rng(12)
    n = 6000
    keys = np.arange(300) if unique else np.arange(300) % 150
    cat = _catalog(big=pd.DataFrame({"k": rng.integers(0, 300, n).astype(np.int64),
                                     "v": rng.random(n)}),
                   dim=pd.DataFrame({"dk": keys.astype(np.int64),
                                     "g": (np.arange(300) % 7).astype(np.int64)}))
    cat.get_table("dim").column("dk").unique = unique

    def plan():
        j = Join(GetTable("big", cat), TableScan(GetTable("dim", cat),
                                                 ast.col("g") < ast.lit(5)),
                 JoinMode.INNER, ("k", "dk"))
        return Sort(Aggregate(j, ["g"], [("s", ast.sum_(ast.col("v"))),
                                         ("n", ast.count_())]), ["g"])

    want = execute_plan(plan()).rows()
    p = plan()
    join = next(op for op in _walk(p) if isinstance(op, Join))
    bq = BlockedQuery(p, cat, block_rows=1000)
    assert bq.n_blocks == 6
    for _ in range(2):
        assert_tables_equal(bq.run().rows(), want, ordered=True, rel_tol=1e-9)
        assert bq.builds == 1 and join.path == path and join.build_cache is None


def test_streamed_multi_key_join_packs_its_build_side_once():
    rng = np.random.default_rng(13)
    n = 5000
    cat = _catalog(big=pd.DataFrame({"a": rng.integers(0, 20, n).astype(np.int64),
                                     "b": rng.integers(0, 30, n).astype(np.int64),
                                     "v": rng.random(n)}),
                   dim=pd.DataFrame({"x": np.repeat(np.arange(20), 30).astype(np.int64),
                                     "y": np.tile(np.arange(30), 20).astype(np.int64),
                                     "w": np.arange(600, dtype=np.int64)}))

    def plan():
        j = MultiKeyJoin(GetTable("big", cat), GetTable("dim", cat), ("a", "x"),
                         [("b", "y", ast.col("b") == ast.col("y"))])
        return Aggregate(j, [], [("s", ast.sum_(ast.col("w"))), ("n", ast.count_())])

    want = execute_plan(plan()).rows()
    assert want[0][1] == n
    bq = BlockedQuery(plan(), cat, block_rows=1024)
    assert bq.run().rows() == want
    assert bq.n_blocks == 5 and bq.builds == 2  # the packed table, then its build side

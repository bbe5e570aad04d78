"""Distributed execution (hyrise_tpu_torch/parallel/dist_compiler.py) on
the CPU, after tests/test_dist_compiler.py and tests/test_dist_sql.py.

- All 22 hand plans over 8 in-process CPU shards at SF 0.01 equal the
  port's single-node answers (ints and strings exact, floats within 1e-6
  relative, in order), and again on a second run.
- Q1, Q3, Q5, Q6, Q9, Q18 and Q21 equal the JAX DistributedCompiledQuery
  on the 8-device CPU mesh: the same rows, the same join decisions and the
  same exchange_stats() (labels, sites, rows, moved rows).
- On synthetic tables: every join mode under broadcast, shuffle and MPSM;
  the co-partitioned join staying local; the two-phase aggregate for every
  function, NULL groups and a scalar; COUNT DISTINCT gathering; top K; and
  the synthetic plans' exchange_stats() against the JAX package's.
- The 9 SQL texts of tests/test_dist_sql.py through
  SQLPipelineBuilder.with_distributed_execution equal single-node SQL."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.get_table import GetTable as JGetTable
from hyrise_tpu.ops.join import Join as JJoin, JoinMPSM as JJoinMPSM
from hyrise_tpu.ops.sort import Sort as JSort
from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.parallel.dist_compiler import (DistributedCompiledQuery,
                                               ShardedCatalog as JShardedCatalog,
                                               shard_tpch as jax_shard_tpch)
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.storage.table import Table as JTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu.tpch.queries import TPCH_PLANS as JAX_PLANS
from hyrise_tpu.types import JoinMode as JJoinMode
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join, JoinMPSM
from hyrise_tpu_torch.ops.misc import Limit
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.parallel.dist_compiler import (DistributedQuery, ShardedCatalog,
                                                     bucket_capacity, shard_tpch)
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.tpch.dbgen import generate_tables
from hyrise_tpu_torch.tpch.queries import TPCH_PLANS, TPCH_SQL
from hyrise_tpu_torch.types import DataType, JoinMode, SortMode
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

N = 8
SF = 0.01
JAX_SUBSET = (1, 3, 5, 6, 9, 18, 21)
SQL_QIDS = (1, 3, 4, 5, 6, 10, 14, 16, 18)   # tests/test_dist_sql.py's
_state = {}


def _tpch():
    if "tpch" not in _state:
        cat = Catalog(device="cpu")
        for name, t in generate_tables(SF, device="cpu").items():
            cat.add_table(name, t)
        _state["tpch"] = (cat, shard_tpch(cat, make_mesh(N, device="cpu")))
    return _state["tpch"]


def _jax_tpch():
    if "jax_tpch" not in _state:
        jcat = JCatalog()
        for name, t in jax_generate_tables(SF).items():
            jcat.add_table(name, t)
        _state["jax_tpch"] = (jcat, jax_shard_tpch(jcat, jax_make_mesh(N)))
    return _state["jax_tpch"]


def _decisions(dq):
    return [dq._decisions[id(op)] for op in dq.ops if id(op) in dq._decisions]


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_tpch_distributed_equals_single_node(qid):
    cat, sc = _tpch()
    ref = execute_plan(TPCH_PLANS[qid](cat))
    dq = DistributedQuery(TPCH_PLANS[qid](cat), sc)
    got = dq.run()
    assert got.column_names == ref.column_names
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=1e-6)
    decisions = _decisions(dq)
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-6)
    assert _decisions(dq) == decisions  # kept from the first run


@pytest.mark.parametrize("qid", JAX_SUBSET)
def test_tpch_distributed_equals_the_jax_compiled_query(qid):
    cat, sc = _tpch()
    jcat, jsc = _jax_tpch()
    jdq = DistributedCompiledQuery(JAX_PLANS[qid](jcat), jsc)
    want = jdq.run()
    dq = DistributedQuery(TPCH_PLANS[qid](cat), sc)
    got = dq.run()
    assert got.column_names == want.column_names
    assert_tables_equal(got.rows(), want.rows(), ordered=True, rel_tol=1e-6)
    assert _decisions(dq) == _decisions(jdq)
    assert dq.exchange_stats() == jdq.exchange_stats()


def test_exchange_stats_quantify_the_gathers():
    """Q13 moves rows; Q6 (a scan and a decomposable aggregate) moves only
    its partials."""
    cat, sc = _tpch()
    dq13 = DistributedQuery(TPCH_PLANS[13](cat), sc)
    dq13.run()
    s13 = dq13.exchange_stats()
    assert s13 and sum(e["moved_rows"] for e in s13.values()) > 0
    assert all(e["sites"] >= 1 for e in s13.values())
    dq6 = DistributedQuery(TPCH_PLANS[6](cat), sc)
    dq6.run()
    moved6 = sum(e["moved_rows"] for e in dq6.exchange_stats().values())
    assert moved6 < sc.get("lineitem").num_rows / 10
    # per-shard rows of the stored table each query read
    assert dq6.source_rows()["lineitem"] == list(sc.get("lineitem").counts)


# ---------------------------------------------------------------------------
# synthetic tables, in both packages


def _port_table(name, df):
    cols = []
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_string_dtype(s):
            cols.append(Column.from_numpy(c, DataType.STRING, s.to_numpy(dtype=object),
                                          device="cpu"))
            continue
        kind = {"int32": DataType.INT32, "Int32": DataType.INT32, "int64": DataType.INT64,
                "Int64": DataType.INT64,
                "float32": DataType.FLOAT32, "float64": DataType.FLOAT64,
                "Float64": DataType.FLOAT64}[str(s.dtype)]
        valid = None if not s.isna().any() else ~s.isna().to_numpy()
        values = s.to_numpy(dtype=kind.numpy_dtype, na_value=0)
        cols.append(Column.from_numpy(c, kind, values, validity=valid, device="cpu"))
    return Table(cols, len(df), name=name)


def _mini_frames(n_rows=200, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "fact": pd.DataFrame({"k": rng.integers(0, 40, size=n_rows).astype(np.int64),
                              "g": rng.integers(0, 7, size=n_rows).astype(np.int32),
                              "v": rng.normal(size=n_rows).astype(np.float64)}),
        "dim": pd.DataFrame({"k": np.arange(0, 40, dtype=np.int64),
                             "name": [f"n{i % 5}" for i in range(40)]}),
        "other": pd.DataFrame({"k": rng.integers(0, 40, size=97).astype(np.int64),
                               "w": rng.normal(size=97).astype(np.float64)}),
    }


# name -> partition key, or None for replicated; "other" is partitioned by a
# column that is not the join key, which forces shuffles
MINI_PLACEMENT = {"fact": "k", "dim": None, "other": "w"}


def _envs(frames, placement):
    cat, jcat = Catalog(device="cpu"), JCatalog()
    sc, jsc = ShardedCatalog(make_mesh(N, device="cpu")), JShardedCatalog(jax_make_mesh(N))
    for name, df in frames.items():
        t, jt = _port_table(name, df), JTable.from_pandas(name, df)
        cat.add_table(name, t)
        jcat.add_table(name, jt)
        if placement[name] is None:
            sc.add_replicated(name, t)
            jsc.add_replicated(name, jt)
        else:
            sc.add_sharded(name, t, placement[name])
            jsc.add_sharded(name, jt, placement[name])
    return cat, sc, jcat, jsc


def _mini_env(n_rows=200, seed=0):
    return _envs(_mini_frames(n_rows, seed), MINI_PLACEMENT)


def _check(cat, sc, plan_fn, ordered=False):
    ref = execute_plan(plan_fn(cat))
    dq = DistributedQuery(plan_fn(cat), sc)
    got = dq.run()
    assert_tables_equal(got.rows(), ref.rows(), ordered=ordered, rel_tol=1e-9)
    return dq


def _check_against_jax(env, plan_fn, jax_plan_fn, ordered=False):
    cat, sc, jcat, jsc = env
    dq = _check(cat, sc, plan_fn, ordered)
    jdq = DistributedCompiledQuery(jax_plan_fn(jcat), jsc)
    jax_rows = jdq.run().rows()
    assert_tables_equal(dq.run().rows(), jax_rows, ordered=ordered, rel_tol=1e-9)
    assert _decisions(dq) == _decisions(jdq)
    assert dq.exchange_stats() == jdq.exchange_stats()
    return dq


MODES = ["INNER", "LEFT", "RIGHT", "SEMI", "ANTI"]


@pytest.mark.parametrize("mode", MODES)
def test_broadcast_join_modes(mode):
    def plan(c):
        return Sort(Join(GetTable("fact", c), GetTable("dim", c), JoinMode[mode], ("k", "k")),
                    ["k", "v"])

    def jplan(c):
        return JSort(JJoin(JGetTable("fact", c), JGetTable("dim", c), JJoinMode[mode],
                           ("k", "k")), ["k", "v"])

    dq = _check_against_jax(_mini_env(), plan, jplan)
    assert "broadcast" in _decisions(dq) or "replicated" in _decisions(dq)


@pytest.mark.parametrize("mode", MODES + ["OUTER"])
def test_shuffle_join_modes(mode):
    def plan(c):
        return Sort(Join(GetTable("other", c), GetTable("fact", c), JoinMode[mode], ("k", "k")),
                    ["k", "w"])

    def jplan(c):
        return JSort(JJoin(JGetTable("other", c), JGetTable("fact", c), JJoinMode[mode],
                           ("k", "k")), ["k", "w"])

    _check_against_jax(_mini_env(), plan, jplan)


@pytest.mark.parametrize("mode", MODES)
def test_mpsm_range_clustered_join(mode):
    def plan(c):
        return Sort(JoinMPSM(GetTable("other", c), GetTable("fact", c), JoinMode[mode],
                             ("k", "k")), ["k", "w"])

    def jplan(c):
        return JSort(JJoinMPSM(JGetTable("other", c), JGetTable("fact", c), JJoinMode[mode],
                               ("k", "k")), ["k", "w"])

    dq = _check_against_jax(_mini_env(), plan, jplan)
    (join,) = [op for op in dq.ops if isinstance(op, JoinMPSM)]
    assert dq._decisions[id(join)] == "mpsm"
    assert any("mpsm" in label for label, _ in dq._sites)


def _not_in_frames(build_null: bool):
    """NOT IN's inputs, NULL keys on the probe side. The build side is too
    large to broadcast by size (BROADCAST_MAX_ROWS) and holds two keys: with
    one NULL key besides (every probe row is rejected), or none, so most
    shards hold no build row after a placement by key (a NULL probe key is
    still rejected: the set is not empty)."""
    rng = np.random.default_rng(5)
    pk = pd.array(rng.integers(1, 80, size=160), dtype="Int64")
    pk[rng.choice(160, size=6, replace=False)] = None  # too few to be a hot key
    n_build = 70_000
    bk = pd.array(np.where(np.arange(n_build) % 2 == 0, 3, 7), dtype="Int64")
    if build_null:
        bk[n_build // 2] = None
    return {"np": pd.DataFrame({"k": pk, "w": rng.normal(size=160)}),
            "nb": pd.DataFrame({"k": bk, "x": rng.normal(size=n_build)})}


@pytest.mark.parametrize("build_null", [True, False], ids=["build-null", "no-build-null"])
@pytest.mark.parametrize("layout", ["shuffle", "copart", "mpsm"])
def test_not_in_reads_the_whole_build_side(layout, build_null):
    """ROADMAP C26: NOT IN (ANTI_NULL_AS_TRUE) decides on the whole build
    side (a NULL anywhere in it rejects every row; a NULL probe key is kept
    only if it is empty), so it runs broadcast, never per shard on a part
    of the build side. The answer equals both packages' single-node one."""
    frames = _not_in_frames(build_null)
    key = "k" if layout == "copart" else None
    cat, sc, jcat, _ = _envs(frames, {"np": key or "w", "nb": key or "x"})
    join, jjoin = (JoinMPSM, JJoinMPSM) if layout == "mpsm" else (Join, JJoin)

    def plan(c):
        return Sort(join(GetTable("np", c), GetTable("nb", c), JoinMode.ANTI_NULL_AS_TRUE,
                         ("k", "k")), ["k", "w"])

    dq = _check(cat, sc, plan, ordered=True)
    assert _decisions(dq) == ["broadcast"]
    want = jax_execute_plan(JSort(jjoin(JGetTable("np", jcat), JGetTable("nb", jcat),
                                        JJoinMode.ANTI_NULL_AS_TRUE, ("k", "k")), ["k", "w"]))
    assert_tables_equal(dq.run().rows(), want.rows(), ordered=True, rel_tol=1e-9)
    assert (len(want.rows()) == 0) == build_null


def test_mpsm_skewed_keys_still_exact():
    rng = np.random.default_rng(3)
    keys = np.where(rng.random(400) < 0.7, 7, rng.integers(0, 40, 400))
    frames = {"skl": pd.DataFrame({"k": keys.astype(np.int64), "v": rng.normal(size=400)}),
              "skr": pd.DataFrame({"k": np.arange(0, 40, dtype=np.int64),
                                   "w": rng.normal(size=40)})}
    cat, sc, _, _ = _envs(frames, {"skl": "v", "skr": "w"})

    def plan(c):
        return Sort(JoinMPSM(GetTable("skl", c), GetTable("skr", c), JoinMode.INNER,
                             ("k", "k")), ["k", "v"])

    dq = _check(cat, sc, plan)
    assert _decisions(dq) == ["mpsm"]


def test_copartitioned_join_stays_local():
    cat, sc, _, _ = _mini_env()

    def plan(c):
        return Sort(Join(GetTable("fact", c), GetTable("fact", c), JoinMode.INNER, ("k", "k")),
                    ["k", "v"])

    dq = _check(cat, sc, plan)
    assert _decisions(dq) == ["copart"]
    assert not any("shuffle" in label or "localize" in label for label, _ in dq._sites)


def test_two_phase_aggregate_all_functions():
    def aggs(a):
        return [("s", a.sum_(a.col("v"))), ("a", a.avg_(a.col("v"))), ("mn", a.min_(a.col("v"))),
                ("mx", a.max_(a.col("v"))), ("cnt", a.count_()), ("cv", a.count_(a.col("v")))]

    def plan(c):
        return Sort(Aggregate(GetTable("fact", c), ["g"], aggs(ast)), ["g"])

    def jplan(c):
        return JSort(JAggregate(JGetTable("fact", c), ["g"], aggs(jast)), ["g"])

    dq = _check_against_jax(_mini_env(), plan, jplan, ordered=True)
    assert "exchange.gather" in dict(dq._sites)


def test_count_distinct_falls_back_to_a_gather():
    cat, sc, _, _ = _mini_env()

    def plan(c):
        return Sort(Aggregate(GetTable("fact", c), ["g"],
                              [("d", ast.count_distinct(ast.col("k")))]), ["g"])

    dq = _check(cat, sc, plan, ordered=True)
    assert [label for label, _ in dq._sites] == ["exchange.gather"]
    assert dq._sites[0][1] == [200] * N  # the whole input, not partials


def test_aggregate_on_the_partition_key_stays_local():
    cat, sc, _, _ = _mini_env()

    def plan(c):
        return Sort(Aggregate(GetTable("fact", c), ["k"], [("s", ast.sum_(ast.col("v")))]),
                    ["k"])

    dq = _check(cat, sc, plan, ordered=True)
    assert [label for label, _ in dq._sites] == ["exchange.gather"]  # only the Sort's


def test_aggregate_with_null_groups_and_all_null_inputs():
    rng = np.random.default_rng(1)
    frames = {"t": pd.DataFrame({
        "g": pd.array([None, 1, 2, 1, None, 2, 1, 2] * 8, dtype="Int32"),
        "v": pd.array([None] * 16 + list(rng.normal(size=48)), dtype="Float64"),
        "k": np.arange(64, dtype=np.int64)})}
    cat, sc, _, _ = _envs(frames, {"t": "k"})

    def plan(c):
        return Sort(Aggregate(GetTable("t", c), ["g"], [
            ("s", ast.sum_(ast.col("v"))), ("a", ast.avg_(ast.col("v"))),
            ("cnt", ast.count_(ast.col("v")))]), ["g"])

    _check(cat, sc, plan, ordered=True)


def test_scalar_aggregate_two_phase_with_empty_shards():
    cat, sc, _, _ = _mini_env()

    def plan(c):
        return Aggregate(TableScan(GetTable("fact", c), ast.col("v") > ast.lit(2.0)), [], [
            ("s", ast.sum_(ast.col("v"))), ("n", ast.count_()), ("mx", ast.max_(ast.col("v")))])

    _check(cat, sc, plan, ordered=True)

    def nothing(c):  # every shard empty: SUM and MAX NULL, COUNT 0
        return Aggregate(TableScan(GetTable("fact", c), ast.col("v") > ast.lit(99.0)), [], [
            ("s", ast.sum_(ast.col("v"))), ("n", ast.count_()), ("mx", ast.max_(ast.col("v")))])

    dq = _check(cat, sc, nothing, ordered=True)
    assert dq.run().rows() == [(None, 0, None)]


def test_sort_and_limit_gather():
    cat, sc, _, _ = _mini_env()

    def plan(c):
        return Limit(Sort(GetTable("fact", c), ["v"]), 10)

    _check(cat, sc, plan, ordered=True)


def test_distributed_top_k_gathers_k_rows_a_shard():
    cat, sc, _, _ = _mini_env(n_rows=40000)
    k = 5

    def plan(c):
        return Limit(Sort(GetTable("fact", c), ["v"]), k)

    dq = _check(cat, sc, plan, ordered=True)
    gathers = [counts for label, counts in dq._sites if label == "exchange.gather"]
    assert gathers == [[k * N] * N]
    assert bucket_capacity(k) < int(sc.get("fact").counts.max())


def test_distributed_top_k_descending_with_ties():
    cat, sc, _, _ = _mini_env(n_rows=50, seed=3)

    def plan(c):
        return Limit(Sort(GetTable("fact", c), [("g", SortMode.DESCENDING), "v"]), 20)

    _check(cat, sc, plan, ordered=True)


def test_gather_merges_dictionaries_by_content():
    """Shards that rewrite a dictionary each make their own object; the
    gathered strings decode the same."""
    cat, sc, _, _ = _mini_env()

    def plan(c):
        from hyrise_tpu_torch.ops.projection import Projection
        j = Join(GetTable("fact", c), GetTable("dim", c), JoinMode.INNER, ("k", "k"))
        p = Projection(j, [("s", ast.col("name").substr(1, 1)), "v"])
        return Sort(p, ["v"])

    _check(cat, sc, plan, ordered=True)


@pytest.mark.parametrize("key_expr,decision", [("k + 1", "broadcast"), ("k", "copart"),
                                               ("renamed", "copart")])
def test_a_projection_keeps_the_placement_only_of_a_forwarded_key(key_expr, decision):
    """ROADMAP C25: the JAX package keeps a table's placement through a
    Projection that computes a new column under the key's name, so its join
    runs co-partitioned on values that live elsewhere (0 rows for 99)."""
    from hyrise_tpu_torch.ops.projection import Projection
    frames = {name: pd.DataFrame({"k": np.arange(100, dtype=np.int64),
                                  col: np.arange(100, dtype=np.float64)})
              for name, col in (("a", "v"), ("b", "w"))}
    cat, sc, _, _ = _envs(frames, {"a": "k", "b": "k"})

    def plan(c):
        outputs = {"k + 1": [("k", ast.col("k") + ast.lit(1)), "v"], "k": ["k", "v"],
                   "renamed": [("kk", ast.col("k")), "v"]}[key_expr]
        left = "kk" if key_expr == "renamed" else "k"
        j = Join(Projection(GetTable("a", c), outputs), GetTable("b", c), JoinMode.INNER,
                 (left, "k"))
        return Aggregate(j, [], [("n", ast.count_()), ("s", ast.sum_(ast.col("v")))])

    dq = _check(cat, sc, plan, ordered=True)
    assert _decisions(dq) == [decision]
    assert dq.run().rows()[0][0] == (99 if key_expr == "k + 1" else 100)


def test_undistributable_plans_are_refused():
    from hyrise_tpu_torch.plan.blocked import PlanNotCompilable
    cat, sc, _, _ = _mini_env()
    with pytest.raises(PlanNotCompilable):
        from hyrise_tpu_torch.ops.print_op import Print
        DistributedQuery(Print(GetTable("fact", cat)), sc)
    with pytest.raises(ValueError):
        DistributedQuery(GetTable("fact", cat), sc, exchange="broadcast")


@pytest.mark.parametrize("qid", SQL_QIDS)
def test_sql_distributed_equals_single_node(qid):
    cat, sc = _tpch()
    ref = (SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat).dont_cache_query_plans()
           .create_pipeline().get_result_table())
    pipeline = (SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat)
                .with_distributed_execution(sc).dont_cache_query_plans().create_pipeline())
    got = pipeline.get_result_table()
    assert pipeline.pipeline_statements[-1].last_dist_query is not None
    assert got.column_names == ref.column_names
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=1e-6)


def test_sql_statements_that_need_a_transaction_stay_single_node():
    cat, sc = _tpch()
    pipeline = (SQLPipelineBuilder("SELECT COUNT(*) FROM nation").with_catalog(cat)
                .with_mvcc(True).with_distributed_execution(sc).create_pipeline())
    assert pipeline.get_result_table().rows() == [(25,)]
    assert pipeline.pipeline_statements[-1].last_dist_query is None


def test_sql_reads_back_a_write_made_after_sharding():
    """The ShardedCatalog holds copies taken at one catalog version: after
    an INSERT, or a CREATE TABLE, in the same distributed pipeline a SELECT
    runs on one device and reads the write back; a fresh ShardedCatalog
    distributes again."""
    from hyrise_tpu_torch.concurrency.transaction import MvccData
    cat, _, _, _ = _mini_env()
    fact = cat.get_table("fact")
    fact.mvcc = MvccData.for_new_table(fact.num_rows, fact.capacity, device="cpu")

    def shard():
        shard_cat = ShardedCatalog(make_mesh(N, device="cpu"), source=cat)
        shard_cat.add_sharded("fact", cat.get_table("fact"), "k")
        return shard_cat

    sc = shard()
    select = "SELECT COUNT(*), SUM(k) FROM fact WHERE k >= 1000"

    def run(sql, shard_cat):
        pipeline = (SQLPipelineBuilder(sql).with_catalog(cat).with_distributed_execution(shard_cat)
                    .dont_cache_query_plans().create_pipeline())
        return pipeline.get_result_table().rows(), pipeline.pipeline_statements[-1]

    rows, stmt = run(select, sc)
    assert rows == [(0, None)] and stmt.last_dist_query is not None
    rows, stmt = run("INSERT INTO fact VALUES (1000, 1, 0.5), (1001, 2, 0.25); " + select, sc)
    assert rows == [(2, 2001)] and stmt.last_dist_query is None
    rows, stmt = run("CREATE TABLE fresh (k INT); INSERT INTO fresh VALUES (4);"
                     " SELECT COUNT(*) FROM fresh", sc)
    assert rows == [(1,)] and stmt.last_dist_query is None
    rows, stmt = run(select, shard())
    assert rows == [(2, 2001)] and stmt.last_dist_query is not None

"""Compiled distribution (hyrise_tpu_torch/parallel/dist_compiler.py
DistributedCompiledQuery, and parallel/blocked_dist.py's
BlockedDistributedQuery(compiled=True)) on the CPU, where the capacity mode
of plan/compiler.py runs uncaptured over 8 in-process CPU shards.

- The 22 hand plans at SF 0.01 equal the port's eager DistributedQuery and
  single node (ints and strings exact, floats within 1e-6 relative, in
  order), with the eager form's decisions and exchange_stats(); a second
  run retries nothing.
- Q1, Q3, Q5, Q6, Q9, Q18 and Q21 equal the JAX DistributedCompiledQuery
  in rows, decisions and exchange_stats().
- Synthetic plans: every join mode under broadcast, shuffle, MPSM and
  co-partitioned; the two-phase aggregate; empty shards; COUNT DISTINCT's
  gather; top K; a hot key's skew split; the ring; a gather of
  content-different dictionaries; ROADMAP C25 and C26.
- What the JAX package cannot show: an exchange that overflows its first
  estimate retries and answers right; a source replaced in the
  ShardedCatalog is pinned anew and answered over its new rows.
- Refusals, the SQL route through both builder flags, and the compiled
  blocked form against the JAX BlockedDistributedQuery."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.get_table import GetTable as JGetTable
from hyrise_tpu.ops.join import Join as JJoin
from hyrise_tpu.ops.sort import Sort as JSort
from hyrise_tpu.parallel.blocked_dist import BlockedDistributedQuery as JBlockedDistributedQuery
from hyrise_tpu.parallel.dist_compiler import (DistributedCompiledQuery as JDistributedCompiledQuery,
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
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.join import Join, JoinMPSM
from hyrise_tpu_torch.ops.misc import Limit, UnionAll
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.parallel.blocked_dist import BlockedDistributedQuery
from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery, DistributedQuery,
                                                     ShardedCatalog, bucket_capacity, shard_tpch)
from hyrise_tpu_torch.parallel.exchange import local_join_inner, repartition_by_key
from hyrise_tpu_torch.parallel.mesh import Mesh, make_mesh
from hyrise_tpu_torch.plan.compiler import CompileContext, PlanNotCompilable, _activation
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
BLOCKED_SF = 0.02
JAX_SUBSET = (1, 3, 5, 6, 9, 18, 21)
SQL_QIDS = (1, 3, 4, 5, 6, 10, 14, 16, 18)   # tests/test_dist_sql.py's
_state = {}


def _tpch(sf=SF):
    if ("tpch", sf) not in _state:
        cat = Catalog(device="cpu")
        for name, t in generate_tables(sf, device="cpu").items():
            cat.add_table(name, t)
        _state["tpch", sf] = (cat, shard_tpch(cat, make_mesh(N, device="cpu")))
    return _state["tpch", sf]


def _jax_tpch(sf=SF):
    if ("jax_tpch", sf) not in _state:
        jcat = JCatalog()
        for name, t in jax_generate_tables(sf).items():
            jcat.add_table(name, t)
        _state["jax_tpch", sf] = (jcat, jax_shard_tpch(jcat, jax_make_mesh(N)))
    return _state["jax_tpch", sf]


def _decisions(q):
    return [q._decisions[id(op)] for op in q.ops if id(op) in q._decisions]


def _same(got, want, ordered=True, rel_tol=1e-6):
    assert_tables_equal(got.rows() if hasattr(got, "rows") else got,
                        want.rows() if hasattr(want, "rows") else want,
                        ordered=ordered, rel_tol=rel_tol)


def _compiled_against_eager(cat, sc, plan_fn, ordered=True, exchange="all_to_all"):
    """The compiled answer, twice, against the eager form's and single
    node's; the same decisions and exchange_stats(). Returns both queries."""
    ref = execute_plan(plan_fn(cat))
    dq = DistributedQuery(plan_fn(cat), sc, exchange=exchange)
    _same(dq.run(), ref, ordered, 1e-9)
    cq = DistributedCompiledQuery(plan_fn(cat), sc, exchange=exchange)
    got = cq.run()
    assert got.column_names == ref.column_names
    _same(got, ref, ordered, 1e-9)
    _same(cq.run(), ref, ordered, 1e-9)
    assert cq.last_retries == 0 and cq.pins == 1
    assert cq.join_decisions() == dq.join_decisions()
    assert cq.exchange_stats() == dq.exchange_stats()
    return cq, dq


@pytest.mark.parametrize("qid", sorted(TPCH_PLANS))
def test_tpch_compiled_equals_eager_and_single_node(qid):
    cat, sc = _tpch()
    cq, _ = _compiled_against_eager(cat, sc, TPCH_PLANS[qid])
    assert cq.host_reads == 1 and cq.caps  # one read a run, of learned sites


def _jax_answer(qid):
    """The JAX DistributedCompiledQuery's (rows, decisions, stats), once."""
    if ("jax", qid) not in _state:
        jcat, jsc = _jax_tpch()
        jdq = JDistributedCompiledQuery(JAX_PLANS[qid](jcat), jsc)
        rows = jdq.run().rows()
        _state["jax", qid] = (rows, _decisions(jdq), jdq.exchange_stats())
    return _state["jax", qid]


@pytest.mark.parametrize("qid", JAX_SUBSET)
def test_tpch_compiled_equals_the_jax_compiled_query(qid):
    cat, sc = _tpch()
    rows, decisions, stats = _jax_answer(qid)
    cq = DistributedCompiledQuery(TPCH_PLANS[qid](cat), sc)
    _same(cq.run(), rows)
    assert _decisions(cq._dq) == decisions
    assert cq.exchange_stats() == stats


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
                "Int64": DataType.INT64, "float64": DataType.FLOAT64,
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


# "other" is partitioned by a column that is not the join key: shuffles
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


def _against_jax(plan_fn, jax_plan_fn, ordered=True):
    """As _compiled_against_eager, and equal to the JAX package's compiled
    form in rows, decisions and exchange_stats() (as row sets where the
    plan's sort keys tie, as tests/test_torch_dist_compiler.py holds them)."""
    cat, sc, jcat, jsc = _mini_env()
    cq, _ = _compiled_against_eager(cat, sc, plan_fn, ordered)
    jdq = JDistributedCompiledQuery(jax_plan_fn(jcat), jsc)
    _same(cq.run(), jdq.run(), ordered, 1e-9)
    assert _decisions(cq._dq) == _decisions(jdq)
    assert cq.exchange_stats() == jdq.exchange_stats()
    return cq


MODES = ["INNER", "LEFT", "RIGHT", "SEMI", "ANTI"]


@pytest.mark.parametrize("mode", MODES)
def test_broadcast_join_modes(mode):
    def plan(c):
        return Sort(Join(GetTable("fact", c), GetTable("dim", c), JoinMode[mode], ("k", "k")),
                    ["k", "v"])

    def jplan(c):
        return JSort(JJoin(JGetTable("fact", c), JGetTable("dim", c), JJoinMode[mode],
                           ("k", "k")), ["k", "v"])

    cq = _against_jax(plan, jplan, ordered=False)
    assert {"broadcast", "replicated"} & set(_decisions(cq._dq))


def _shuffle_env():
    """A probe side of 3,000 rows and a build side of 70,000 (too large to
    broadcast), each placed by a column that is not the join key, with no
    hot key: the join shuffles both."""
    if "shuffle" not in _state:
        rng = np.random.default_rng(4)
        frames = {"sp": pd.DataFrame({"k": rng.integers(0, 90_000, 3000).astype(np.int64),
                                      "v": rng.normal(size=3000)}),
                  "sb": pd.DataFrame({"k": np.arange(70_000, dtype=np.int64),
                                      "w": rng.normal(size=70_000)})}
        _state["shuffle"] = _envs(frames, {"sp": "v", "sb": "w"})
    return _state["shuffle"]


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
@pytest.mark.parametrize("mode", MODES + ["OUTER"])
def test_shuffle_join_modes(mode, exchange):
    """Each side shuffles by k through the capacity form, a compaction a
    destination (RIGHT broadcasts its small build side); the ring's answer
    is the eager ring's, the all_to_all's the JAX package's (SEMI and ANTI
    leave a masked table, whose global aggregate the JAX package reads
    wrongly, ROADMAP C4: they are held to single node only)."""
    def plan(c):
        j = Join(GetTable("sp", c), GetTable("sb", c), JoinMode[mode], ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])

    cat, sc, jcat, jsc = _shuffle_env()
    cq, _ = _compiled_against_eager(cat, sc, plan, exchange=exchange)
    assert _decisions(cq._dq) == ["broadcast" if mode == "RIGHT" else "shuffle"]
    if exchange == "all_to_all" and mode not in ("SEMI", "ANTI"):
        jj = JJoin(JGetTable("sp", jcat), JGetTable("sb", jcat), JJoinMode[mode], ("k", "k"))
        jdq = JDistributedCompiledQuery(
            JAggregate(jj, [], [("s", jast.sum_(jast.col("v"))), ("n", jast.count_())]), jsc)
        _same(cq.run(), jdq.run(), True, 1e-9)
        assert cq.exchange_stats() == jdq.exchange_stats()


@pytest.mark.parametrize("mode", MODES)
def test_mpsm_range_clustered_join(mode):
    def plan(c):
        return Sort(JoinMPSM(GetTable("other", c), GetTable("fact", c), JoinMode[mode],
                             ("k", "k")), ["k", "w"])

    cq, _ = _compiled_against_eager(*_mini_env()[:2], plan, ordered=False)
    assert _decisions(cq._dq) == ["mpsm"]
    assert any("mpsm" in label for label in cq.exchange_stats())


@pytest.mark.parametrize("mode", MODES + ["OUTER"])
def test_copartitioned_join_stays_local(mode):
    def plan(c):
        return Sort(Join(GetTable("fact", c), GetTable("fact", c), JoinMode[mode], ("k", "k")),
                    ["k", "v", "g"])

    cq, _ = _compiled_against_eager(*_mini_env()[:2], plan, ordered=False)
    assert _decisions(cq._dq) == ["copart"]
    assert set(cq.exchange_stats()) == {"exchange.gather"}


def test_two_phase_aggregate_all_functions():
    def aggs(a):
        return [("s", a.sum_(a.col("v"))), ("a", a.avg_(a.col("v"))), ("mn", a.min_(a.col("v"))),
                ("mx", a.max_(a.col("v"))), ("cnt", a.count_()), ("cv", a.count_(a.col("v")))]

    def plan(c):
        return Sort(Aggregate(GetTable("fact", c), ["g"], aggs(ast)), ["g"])

    def jplan(c):
        return JSort(JAggregate(JGetTable("fact", c), ["g"], aggs(jast)), ["g"])

    _against_jax(plan, jplan)


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

    _compiled_against_eager(cat, sc, plan)


def test_scalar_aggregate_over_empty_shards():
    """Two rows over 8 shards: most shards hold none (one dead row in
    capacity mode); then a filter keeps nothing on any shard."""
    frames = {"t": pd.DataFrame({"k": np.array([3, 11], dtype=np.int64),
                                 "v": np.array([1.5, 2.5])})}
    cat, sc, _, _ = _envs(frames, {"t": "k"})
    assert 0 in list(sc.get("t").counts)

    def plan(c):
        return Aggregate(GetTable("t", c), [], [
            ("s", ast.sum_(ast.col("v"))), ("n", ast.count_()), ("mx", ast.max_(ast.col("v")))])

    def nothing(c):
        return Aggregate(TableScan(GetTable("t", c), ast.col("v") > ast.lit(99.0)), [], [
            ("s", ast.sum_(ast.col("v"))), ("n", ast.count_()), ("mx", ast.max_(ast.col("v")))])

    cq, _ = _compiled_against_eager(cat, sc, plan)
    assert cq.run().rows() == [(4.0, 2, 2.5)]
    cq, _ = _compiled_against_eager(cat, sc, nothing)
    assert cq.run().rows() == [(None, 0, None)]


def test_count_distinct_gathers_its_input():
    def plan(c):
        return Sort(Aggregate(GetTable("fact", c), ["g"],
                              [("d", ast.count_distinct(ast.col("k")))]), ["g"])

    cq, _ = _compiled_against_eager(*_mini_env()[:2], plan)
    assert cq.exchange_stats()["exchange.gather"] == \
        {"sites": 1, "rows": 200, "moved_rows": 200 * (N - 1)}  # the input, not partials


@pytest.mark.parametrize("k,sort", [(5, ["v"]), (20, [("g", SortMode.DESCENDING), "v"])])
def test_distributed_top_k(k, sort):
    cat, sc, _, _ = _mini_env(n_rows=4000)

    def plan(c):
        return Limit(Sort(GetTable("fact", c), sort), k)

    cq, _ = _compiled_against_eager(cat, sc, plan)
    assert cq.exchange_stats()["exchange.gather"]["rows"] == k * N
    # K rows a shard travel at K's bucket, not the shard's capacity
    assert max(cq.caps) < sc.get("fact").num_rows


def _skew_env(n_fact=6000, n_dim=70_000, hot_frac=0.6, seed=2):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_dim, size=n_fact).astype(np.int64)
    k[rng.random(n_fact) < hot_frac] = 7
    frames = {"sf": pd.DataFrame({"k": k, "v": rng.normal(size=n_fact)}),
              "sd": pd.DataFrame({"k": np.arange(n_dim, dtype=np.int64),
                                  "w": rng.normal(size=n_dim),
                                  "salt": rng.integers(0, 1 << 30, size=n_dim).astype(np.int64)})}
    return _envs(frames, {"sf": "v", "sd": "salt"})


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
@pytest.mark.parametrize("mode", ["INNER", "LEFT", "SEMI"])
def test_hot_key_takes_the_skew_split(mode, exchange):
    """The build side is too large to broadcast: a shuffle, with key 7's
    probe rows spread round-robin and its build rows on every shard."""
    if "skew" not in _state:
        _state["skew"] = _skew_env()
    cat, sc, jcat, jsc = _state["skew"]

    def plan(c):
        j = Join(GetTable("sf", c), GetTable("sd", c), JoinMode[mode], ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])

    cq, _ = _compiled_against_eager(cat, sc, plan, exchange=exchange)
    assert _decisions(cq._dq) == ["shuffle"]
    assert 7 in list(cq._dq._hot_keys.values())[0]
    assert {"join.shuffle_p", "join.shuffle_b.nonhot", "join.shuffle_b.merge"} <= \
        set(cq.exchange_stats())
    jdq = JDistributedCompiledQuery(JAggregate(JJoin(JGetTable("sf", jcat), JGetTable("sd", jcat),
                                                     JJoinMode[mode], ("k", "k")), [],
                                               [("s", jast.sum_(jast.col("v"))),
                                                ("n", jast.count_())]), jsc)
    _same(cq.run(), jdq.run(), True, 1e-9)
    assert cq.exchange_stats() == jdq.exchange_stats()


def test_gather_merges_dictionaries_by_content():
    """Each shard's SUBSTR makes a dictionary of its own: the gathered
    strings decode the same."""
    def plan(c):
        j = Join(GetTable("fact", c), GetTable("dim", c), JoinMode.INNER, ("k", "k"))
        return Sort(Projection(j, [("s", ast.col("name").substr(1, 1)), "v"]), ["v"])

    _compiled_against_eager(*_mini_env()[:2], plan)


@pytest.mark.parametrize("key_expr,decision", [("k + 1", "broadcast"), ("k", "copart"),
                                               ("renamed", "copart")])
def test_a_projection_keeps_the_placement_only_of_a_forwarded_key(key_expr, decision):
    """ROADMAP C25 stays fixed in the compiled form."""
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

    cq, _ = _compiled_against_eager(cat, sc, plan)
    assert _decisions(cq._dq) == [decision]
    assert cq.run().rows()[0][0] == (99 if key_expr == "k + 1" else 100)


@pytest.mark.parametrize("build_null", [True, False], ids=["build-null", "no-build-null"])
@pytest.mark.parametrize("layout", ["shuffle", "copart", "mpsm"])
def test_not_in_reads_the_whole_build_side(layout, build_null):
    """ROADMAP C26 stays fixed: NOT IN runs broadcast in every layout."""
    rng = np.random.default_rng(5)
    pk = pd.array(rng.integers(1, 80, size=160), dtype="Int64")
    pk[rng.choice(160, size=6, replace=False)] = None
    n_build = 70_000
    bk = pd.array(np.where(np.arange(n_build) % 2 == 0, 3, 7), dtype="Int64")
    if build_null:
        bk[n_build // 2] = None
    frames = {"np": pd.DataFrame({"k": pk, "w": rng.normal(size=160)}),
              "nb": pd.DataFrame({"k": bk, "x": rng.normal(size=n_build)})}
    key = "k" if layout == "copart" else None
    cat, sc, _, _ = _envs(frames, {"np": key or "w", "nb": key or "x"})
    join = JoinMPSM if layout == "mpsm" else Join

    def plan(c):
        return Sort(join(GetTable("np", c), GetTable("nb", c), JoinMode.ANTI_NULL_AS_TRUE,
                         ("k", "k")), ["k", "w"])

    cq, _ = _compiled_against_eager(cat, sc, plan)
    assert _decisions(cq._dq) == ["broadcast"]
    assert (len(cq.run().rows()) == 0) == build_null


# ---------------------------------------------------------------------------
# what the JAX package cannot show


def test_an_exchange_over_its_first_estimate_retries():
    """An OUTER join takes no skew split: every probe row has key 7, so one
    shard receives them all, past the first run's estimate (the largest
    shard's capacity). The run grows that site and runs again."""
    rng = np.random.default_rng(9)
    frames = {"p": pd.DataFrame({"k": np.full(3000, 7, dtype=np.int64),
                                 "v": rng.normal(size=3000)}),
              "b": pd.DataFrame({"k": np.arange(70_000, dtype=np.int64),
                                 "w": rng.normal(size=70_000)})}
    cat, sc, _, _ = _envs(frames, {"p": "v", "b": "w"})

    def plan(c):
        j = Join(GetTable("p", c), GetTable("b", c), JoinMode.OUTER, ("k", "k"))
        return Aggregate(j, [], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())])

    ref = execute_plan(plan(cat))
    cq = DistributedCompiledQuery(plan(cat), sc)
    _same(cq.run(), ref, True, 1e-9)
    assert cq.last_retries >= 1
    assert cq.exchange_stats()["join.shuffle_l"]["rows"] == 3000
    _same(cq.run(), ref, True, 1e-9)
    assert cq.last_retries == 0


def test_a_replaced_source_is_pinned_anew():
    """add_sharded replaces fact by half of its rows, placed by another
    column: the compiled query drops its graph, pins the decisions anew
    (co-partitioned becomes a broadcast) and answers over the new rows."""
    frames = _mini_frames(n_rows=400)
    cat, sc, _, _ = _envs(frames, MINI_PLACEMENT)

    def plan(c):
        j = Join(GetTable("fact", c), GetTable("fact", c), JoinMode.INNER, ("k", "k"))
        return Aggregate(j, ["g"], [("n", ast.count_()), ("s", ast.sum_(ast.col("v")))])

    cq = DistributedCompiledQuery(Sort(plan(cat), ["g"]), sc)
    _same(cq.run(), execute_plan(Sort(plan(cat), ["g"])))
    assert cq.join_decisions()[0].endswith("copart")
    half = _port_table("fact", frames["fact"].iloc[:200])
    cat.replace_table("fact", half)
    sc.add_sharded("fact", half, "v")
    got = cq.run()
    assert cq.pins == 2 and cq.join_decisions()[0].endswith("broadcast")
    _same(got, execute_plan(Sort(plan(cat), ["g"])))
    _same(got, DistributedQuery(Sort(plan(cat), ["g"]), sc).run())


def test_exchange_capacity_forms():
    """repartition_by_key and local_join_inner in capacity mode: each
    destination's rows in the eager order, counted on the device."""
    mesh = make_mesh(4, device="cpu")
    rng = np.random.default_rng(3)
    keys = [torch.as_tensor(rng.integers(0, 50, size=n)) for n in (30, 0 + 1, 17, 40)]
    vals = [k.to(torch.float64) * 2 for k in keys]
    valid = [torch.as_tensor(rng.random(k.shape[0]) < 0.8) for k in keys]
    want = repartition_by_key(mesh, [(v,) for v in vals], keys, valid)
    p_want, b_want = local_join_inner(keys[0], None, keys[2], valid[2])
    with _activation(CompileContext([])):
        got = repartition_by_key(mesh, [(v,) for v in vals], keys, valid)
        for ((w_cols, w_key), (g_cols, g_key, count)) in zip(want, got):
            n = int(count)
            assert n == w_key.shape[0]
            assert torch.equal(g_key[:n], w_key) and torch.equal(g_cols[0][:n], w_cols[0])
        probe, build, pairs = local_join_inner(keys[0], None, keys[2], valid[2])
    n = int(pairs)
    assert n == p_want.shape[0]
    assert torch.equal(probe[:n], p_want) and torch.equal(build[:n], b_want)


def test_the_join_step_in_capacity_mode():
    """exchange.dist_join_aggregate_step over the capacity forms equals its
    eager form, through both exchanges."""
    from hyrise_tpu_torch.parallel.exchange import dist_join_aggregate_step
    from hyrise_tpu_torch.parallel.partition import hash_partition

    rng = np.random.default_rng(8)
    mesh = make_mesh(4, device="cpu")
    orders = Table([Column.from_numpy("o_orderkey", DataType.INT64,
                                      np.arange(300, dtype=np.int64), device="cpu")], 300)
    li = Table([Column.from_numpy(name, kind, values, device="cpu") for name, kind, values in (
        ("l_orderkey", DataType.INT64, rng.integers(0, 400, 2000).astype(np.int64)),
        ("l_price", DataType.FLOAT32, rng.random(2000).astype(np.float32) * 100),
        ("l_discount", DataType.FLOAT32, rng.random(2000).astype(np.float32) / 10),
        ("salt", DataType.INT64, rng.integers(0, 1 << 30, 2000).astype(np.int64)))], 2000)
    so, sl = hash_partition(orders, "o_orderkey", mesh), hash_partition(li, "salt", mesh)
    args = ([t.column("l_orderkey").data for t in sl.shards],
            [t.column("l_price").data for t in sl.shards],
            [t.column("l_discount").data for t in sl.shards],
            [torch.ones(t.num_rows, dtype=torch.bool) for t in sl.shards],
            [t.column("o_orderkey").data for t in so.shards],
            [torch.ones(t.num_rows, dtype=torch.bool) for t in so.shards])
    for exchange in ("all_to_all", "ring"):
        revenue, matches = dist_join_aggregate_step(mesh, exchange)(*args)
        with _activation(CompileContext([])):
            cap_revenue, cap_matches = dist_join_aggregate_step(mesh, exchange)(*args)
        assert int(cap_matches) == int(matches) > 0
        assert abs(float(cap_revenue) - float(revenue)) <= 1e-9 * float(revenue)


def test_refusals():
    """IndexScan and JoinIndex run over shards: tests/test_torch_dist_index.py
    holds them against the JAX package."""
    from hyrise_tpu_torch.concurrency.transaction import MvccData
    from hyrise_tpu_torch.ops.print_op import Print
    from hyrise_tpu_torch.ops.rw_ops import Delete

    cat, sc, _, _ = _mini_env()
    refused = [Print(GetTable("fact", cat)), Delete("fact", GetTable("fact", cat), cat)]
    for plan in refused:
        with pytest.raises(PlanNotCompilable):
            DistributedCompiledQuery(plan, sc)
    dim = cat.get_table("dim")
    mvcc = Table(dim.columns, dim.num_rows, name="dim")
    mvcc.mvcc = MvccData.for_new_table(dim.num_rows, dim.capacity, device="cpu")
    sc.add_replicated("dim", mvcc)
    with pytest.raises(PlanNotCompilable, match="MVCC"):
        DistributedCompiledQuery(GetTable("dim", cat), sc)
    two = ShardedCatalog(Mesh([torch.device("cpu"), torch.device("meta")]))
    with pytest.raises(PlanNotCompilable, match="devices"):
        DistributedCompiledQuery(GetTable("fact", cat), two)


# ---------------------------------------------------------------------------
# SQL


@pytest.mark.parametrize("qid", SQL_QIDS)
def test_sql_through_both_flags(qid):
    """Each statement runs as a DistributedCompiledQuery, cached per text
    and ShardedCatalog: the second caller replays it."""
    cat, sc = _tpch()
    ref = (SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat).dont_cache_query_plans()
           .create_pipeline().get_result_table())
    ran = []
    for _ in range(2):
        pipeline = (SQLPipelineBuilder(TPCH_SQL[qid]).with_catalog(cat)
                    .with_distributed_execution(sc).with_compiled_execution().create_pipeline())
        got = pipeline.get_result_table()
        stmt = pipeline.pipeline_statements[-1]
        assert isinstance(stmt.last_dist_query, DistributedCompiledQuery) and stmt.last_compiled
        ran.append(stmt.last_dist_query)
        assert got.column_names == ref.column_names
        _same(got, ref)
    assert ran[0] is ran[1] and ran[1].captures == 0  # no graph on the CPU


def test_sql_a_refused_plan_runs_eagerly_distributed():
    """A plan the compiled form refuses takes the eager DistributedQuery;
    with_distributed_execution alone stays eager."""
    from hyrise_tpu_torch.parallel import dist_compiler

    cat, sc = _tpch()
    sql = "SELECT COUNT(*) FROM orders"
    pipeline = (SQLPipelineBuilder(sql).with_catalog(cat).with_distributed_execution(sc)
                .dont_cache_query_plans().create_pipeline())
    assert pipeline.get_result_table().rows() == [(15000,)]
    assert type(pipeline.pipeline_statements[-1].last_dist_query) is DistributedQuery
    saved = dist_compiler.DistributedCompiledQuery.__init__

    def refuse(self, *a, **k):
        raise PlanNotCompilable("refused for the test")

    dist_compiler.DistributedCompiledQuery.__init__ = refuse
    try:
        pipeline = (SQLPipelineBuilder(sql).with_catalog(cat).with_distributed_execution(sc)
                    .with_compiled_execution().dont_cache_query_plans().create_pipeline())
        assert pipeline.get_result_table().rows() == [(15000,)]
    finally:
        dist_compiler.DistributedCompiledQuery.__init__ = saved
    stmt = pipeline.pipeline_statements[-1]
    assert type(stmt.last_dist_query) is DistributedQuery and not stmt.last_compiled


# ---------------------------------------------------------------------------
# the compiled blocked form


@pytest.mark.parametrize("qid", [1, 3, 6])
def test_compiled_blocked_equals_the_jax_blocked_query(qid):
    """Both packages stream lineitem in a quarter of the JAX form's padded
    shard capacity; the learned capacities are bounded by the blocks."""
    cat, sc = _tpch(BLOCKED_SF)
    jcat, jsc = _jax_tpch(BLOCKED_SF)
    block = jsc.get("lineitem").shard_capacity // 4
    want = JBlockedDistributedQuery(JAX_PLANS[qid](jcat), jsc, block_rows=block).run()
    bq = BlockedDistributedQuery(TPCH_PLANS[qid](cat), sc, block_rows=block, compiled=True)
    got = bq.run()
    assert bq.n_blocks >= 2
    assert got.column_names == want.column_names
    _same(got, want)
    _same(bq.run(), want)
    assert bq.last_retries == 0 and bq.host_reads == 2  # the stacked counts, the merge's
    assert max(bq.caps) <= bucket_capacity(N * block)


def test_compiled_blocked_partial_last_block_and_eager_decisions():
    """Blocks of a third of the largest shard plus one row: the last block
    is partial on every shard. The answer and the decisions are the eager
    blocked form's; the off-path exchanges run once a block."""
    cat, sc = _tpch(BLOCKED_SF)
    block = int(sc.get("lineitem").counts.max()) // 3 + 1
    eager = BlockedDistributedQuery(TPCH_PLANS[3](cat), sc, block_rows=block)
    want = eager.run()
    bq = BlockedDistributedQuery(TPCH_PLANS[3](cat), sc, block_rows=block, compiled=True)
    _same(bq.run(), want)
    assert bq.n_blocks == 3 and bq.builds == 3
    assert bq._block_cq.join_decisions() == eager.join_decisions()
    gathers = bq.exchange_stats()["exchange.gather"]["sites"]
    assert gathers == 2 * bq.n_blocks  # customer and the partial, a block


def test_compiled_blocked_refusals():
    cat, sc = _tpch(BLOCKED_SF)
    two = Table([Column("l_quantity", DataType.FLOAT32, torch.ones(2))], 2, name="two")
    union = Aggregate(UnionAll(Projection(GetTable("lineitem", cat), ["l_quantity"]),
                               TableWrapper(two)), [], [("n", ast.count_())])
    for plan in (union, TPCH_PLANS[2](cat), TPCH_PLANS[18](cat)):
        with pytest.raises(PlanNotCompilable):
            BlockedDistributedQuery(plan, sc, stream_table="lineitem", block_rows=1000,
                                    compiled=True)

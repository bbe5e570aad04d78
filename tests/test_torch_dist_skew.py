"""Skew on the distributed path (hyrise_tpu_torch/parallel/skew.py and the
hot-key split of dist_compiler.py), after tests/test_dist_skew.py and
tests/test_skew.py.

The same pandas frames go into both packages. A join whose build side is
too large to broadcast must shuffle; with one key holding half of the
probe rows the executor spreads that key's probe rows round-robin and puts
its build rows on every shard: the answers stay exact in every mode, and
the hot keys, decisions and exchange_stats() equal the JAX
DistributedCompiledQuery's on the 8-device CPU mesh."""

import numpy as np
import pandas as pd
import pytest
import torch

from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.get_table import GetTable as JGetTable
from hyrise_tpu.ops.join import Join as JJoin
from hyrise_tpu.parallel.dist_compiler import (DistributedCompiledQuery,
                                               ShardedCatalog as JShardedCatalog)
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.parallel.partition import hash_partition as jax_hash_partition
from hyrise_tpu.parallel.skew import (detect_hot_keys as jax_detect_hot_keys,
                                      shard_imbalance as jax_shard_imbalance,
                                      split_hot_keys as jax_split_hot_keys)
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.storage.table import Table as JTable
from hyrise_tpu.types import JoinMode as JJoinMode
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.parallel.dist_compiler import DistributedQuery, ShardedCatalog
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.parallel.partition import hash_partition
from hyrise_tpu_torch.parallel.skew import (detect_hot_keys, detect_hot_keys_sharded,
                                            needs_rebalance, shard_imbalance, split_hot_keys)
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, JoinMode
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

N = 8
_state = {}


def _port_table(name, df):
    kinds = {"int32": DataType.INT32, "int64": DataType.INT64, "float64": DataType.FLOAT64}
    return Table([Column.from_numpy(c, kinds[str(df[c].dtype)], df[c].to_numpy(), device="cpu")
                  for c in df.columns], len(df), name=name)


def _frames(n_fact, n_dim, hot_frac, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_dim, size=n_fact).astype(np.int64)
    k[rng.random(n_fact) < hot_frac] = 7  # one heavy-hitter key
    fact = pd.DataFrame({"k": k, "v": rng.normal(size=n_fact)})
    dim = pd.DataFrame({"k": np.arange(n_dim, dtype=np.int64), "w": rng.normal(size=n_dim),
                        "salt": rng.integers(0, 1 << 30, size=n_dim).astype(np.int64)})
    return fact, dim


def _env(n_fact, n_dim, hot_frac=0.6, seed=2):
    """Both tables sharded by columns that are not the join key, in both
    packages: the join must shuffle by k (or broadcast a small dim)."""
    key = (n_fact, n_dim, hot_frac, seed)
    if key not in _state:
        fact, dim = _frames(n_fact, n_dim, hot_frac, seed)
        cat, jcat = Catalog(device="cpu"), JCatalog()
        sc, jsc = ShardedCatalog(make_mesh(N, device="cpu")), JShardedCatalog(jax_make_mesh(N))
        for name, df, part in (("fact", fact, "v"), ("dim", dim, "salt")):
            t, jt = _port_table(name, df), JTable.from_pandas(name, df)
            cat.add_table(name, t)
            jcat.add_table(name, jt)
            sc.add_sharded(name, t, part)
            jsc.add_sharded(name, jt, part)
        _state[key] = (cat, sc, jcat, jsc, fact)
    return _state[key]


def _plan(c, mode=JoinMode.INNER, a=ast, get=GetTable, join=Join, agg=Aggregate):
    j = join(get("fact", c), get("dim", c), mode, ("k", "k"))
    cols = [("s", a.sum_(a.col("v"))), ("n", a.count_())]
    if mode in (JoinMode.INNER, JJoinMode.INNER):
        cols.append(("sw", a.sum_(a.col("w"))))
    return agg(j, [], cols)


def _jplan(c, mode=JJoinMode.INNER):
    return _plan(c, mode, jast, JGetTable, JJoin, JAggregate)


def test_skewed_shuffle_join_is_exact():
    cat, sc, _, _, _ = _env(4000, 500)

    def plan(c):
        j = Join(GetTable("fact", c), GetTable("dim", c), JoinMode.INNER, ("k", "k"))
        return Sort(Aggregate(j, ["k"], [("s", ast.sum_(ast.col("v"))), ("n", ast.count_())]),
                    ["k"])

    ref = execute_plan(plan(cat))
    dq = DistributedQuery(plan(cat), sc)
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-9)
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-9)


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
def test_hot_key_split_engages_on_a_shuffle_join(exchange):
    cat, sc, jcat, jsc, _ = _env(120_000, 70_000, hot_frac=0.5, seed=5)
    ref = execute_plan(_plan(cat))
    dq = DistributedQuery(_plan(cat), sc, exchange=exchange)
    got = dq.run()
    assert_tables_equal(got.rows(), ref.rows(), ordered=True, rel_tol=1e-9)
    (hot,) = dq._hot_keys.values()
    assert 7 in hot.tolist()
    assert list(dq._decisions.values()) == ["shuffle"]
    # the spread probe shuffle: no shard receives the hot key's 60,000 rows
    (probe,) = [counts for label, counts in dq._sites if label == "join.shuffle_p"]
    assert sum(probe) == 120_000 and max(probe) < 120_000 / N * 1.3
    # the JAX package: same hot keys, decision and exchange sites
    jdq = DistributedCompiledQuery(_jplan(jcat), jsc)
    assert_tables_equal(got.rows(), jdq.run().rows(), ordered=True, rel_tol=1e-9)
    (jhot,) = jdq._hot_keys.values()
    np.testing.assert_array_equal(hot, jhot)
    assert dq.exchange_stats() == jdq.exchange_stats()
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-9)


@pytest.mark.parametrize("mode", ["INNER", "LEFT", "SEMI", "ANTI", "RIGHT", "OUTER"])
def test_hot_key_split_join_modes(mode):
    """Hot build rows on every shard must not repeat output rows: each probe
    row lives on one shard (RIGHT probes the build side; OUTER takes no
    split)."""
    cat, sc, _, _, _ = _env(40_000, 70_000, hot_frac=0.5, seed=5)
    ref = execute_plan(_plan(cat, JoinMode[mode]))
    dq = DistributedQuery(_plan(cat, JoinMode[mode]), sc)
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=True, rel_tol=1e-9)
    hot = list(dq._hot_keys.values())
    if mode in ("INNER", "LEFT", "SEMI", "ANTI"):
        assert 7 in hot[0].tolist()
    if mode == "OUTER":
        assert hot[0].size == 0


def test_skew_detection_equals_jax():
    cat, sc, jcat, _, fact = _env(4000, 500)
    t, jt = cat.get_table("fact"), jcat.get_table("fact")
    hot = detect_hot_keys(t, "k", N)
    np.testing.assert_array_equal(hot, jax_detect_hot_keys(jt, "k", N))
    assert 7 in hot.tolist()
    mesh = make_mesh(N, device="cpu")
    st = hash_partition(t, "k", mesh)
    assert shard_imbalance(st) == pytest.approx(
        jax_shard_imbalance(jax_hash_partition(jt, "k", jax_make_mesh(N))))
    assert shard_imbalance(st) > 1.0 and needs_rebalance(st)
    np.testing.assert_array_equal(detect_hot_keys_sharded(st, "k"), hot)
    targets = split_hot_keys(t, "k", hot, N)
    np.testing.assert_array_equal(targets, jax_split_hot_keys(jt, "k", hot, N))
    counts = np.bincount(targets, minlength=N).astype(np.float64)
    assert counts.max() / counts.mean() - 1.0 < 0.5


def test_balanced_table_needs_no_rebalance():
    t = Table([Column.from_numpy("k", DataType.INT32, np.arange(1, 8001, dtype=np.int32),
                                 device="cpu")], 8000)
    st = hash_partition(t, "k", make_mesh(N, device="cpu"))
    assert shard_imbalance(st) < 0.2 and not needs_rebalance(st, threshold=0.5)
    assert detect_hot_keys(t, "k", N).size == 0


def test_hot_keys_are_capped_at_the_heaviest():
    """More hot keys than the cap: the heaviest 64, as the JAX package keeps."""
    keys = np.repeat(np.arange(100, dtype=np.int64), np.arange(100, dtype=np.int64) + 100)
    t = Table([Column.from_numpy("k", DataType.INT64, keys, device="cpu")], len(keys))
    jt = JTable.from_pandas("t", pd.DataFrame({"k": keys}))
    hot = detect_hot_keys(t, "k", 1024)
    assert len(hot) == 64 and hot.tolist() == list(range(36, 100))
    np.testing.assert_array_equal(hot, jax_detect_hot_keys(jt, "k", 1024))

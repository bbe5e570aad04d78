"""Runtime-feedback placement (hyrise_tpu_torch/parallel/placement.py),
after tests/test_placement.py: the NUMAPlacementManager analogue migrates a
stored sharded table from the per-shard rows DistributedQuery reports, and
answers stay those of the single-node plan and of the JAX package's
manager over the same frame."""

import numpy as np
import pandas as pd
import torch

from hyrise_tpu.expression import ast as jast
from hyrise_tpu.ops.aggregate import Aggregate as JAggregate
from hyrise_tpu.ops.get_table import GetTable as JGetTable
from hyrise_tpu.parallel.dist_compiler import (DistributedCompiledQuery,
                                               ShardedCatalog as JShardedCatalog)
from hyrise_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyrise_tpu.parallel.placement import PlacementManager as JPlacementManager
from hyrise_tpu.parallel.skew import shard_imbalance as jax_shard_imbalance
from hyrise_tpu.storage.catalog import Catalog as JCatalog
from hyrise_tpu.storage.table import Table as JTable
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.parallel.dist_compiler import DistributedQuery, ShardedCatalog
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.parallel.placement import (IMBALANCE_THRESHOLD, AccessCounter,
                                                 PlacementManager)
from hyrise_tpu_torch.parallel.skew import shard_imbalance
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils.table_eq import assert_tables_equal

torch.set_num_threads(1)

N = 8


def _frame(n=4000, hot_frac=0.6, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 500, size=n).astype(np.int64)
    k[rng.random(n) < hot_frac] = 7  # one heavy-hitter key
    return pd.DataFrame({"k": k, "v": rng.normal(size=n)})


def _envs():
    """fact partitioned BY the skewed key in both packages: 60% of its rows
    on one shard."""
    df = _frame()
    t = Table([Column.from_numpy("k", DataType.INT64, df["k"].to_numpy(), device="cpu"),
               Column.from_numpy("v", DataType.FLOAT64, df["v"].to_numpy(), device="cpu")],
              len(df), name="fact")
    cat, jcat = Catalog(device="cpu"), JCatalog()
    cat.add_table("fact", t)
    jcat.add_table("fact", JTable.from_pandas("fact", df))
    sc, jsc = ShardedCatalog(make_mesh(N, device="cpu")), JShardedCatalog(jax_make_mesh(N))
    sc.add_sharded("fact", t, "k")
    jsc.add_sharded("fact", jcat.get_table("fact"), "k")
    return cat, sc, jcat, jsc


def _plan(c):
    return Aggregate(GetTable("fact", c), ["k"], [("s", ast.sum_(ast.col("v")))])


def _jplan(c):
    return JAggregate(JGetTable("fact", c), ["k"], [("s", jast.sum_(jast.col("v")))])


def test_access_counter_decay_and_imbalance():
    c = AccessCounter(4, history=3)
    assert c.imbalance() == 0.0
    c.record([100, 0, 0, 0])
    assert c.imbalance() > 2.0
    for _ in range(3):  # a balanced recent history pushes the spike out
        c.record([25, 25, 25, 25])
    assert c.imbalance() < 0.1


def test_placement_migrates_the_hot_table_and_stays_correct():
    cat, sc, jcat, jsc = _envs()
    ref = execute_plan(_plan(cat))
    before = shard_imbalance(sc.get("fact"))
    assert before > 1.0

    pm, jpm = PlacementManager(cat, sc), JPlacementManager(jcat, jsc)
    dq, jdq = DistributedQuery(_plan(cat), sc), DistributedCompiledQuery(_jplan(jcat), jsc)
    assert_tables_equal(dq.run().rows(), ref.rows(), ordered=False, rel_tol=1e-9)
    jdq.run()
    assert dq.source_rows() == {"fact": list(sc.get("fact").counts)}
    pm.observe(dq)
    jpm.observe(jdq)
    assert pm.imbalance("fact") > IMBALANCE_THRESHOLD
    assert pm.imbalance("fact") == jpm.imbalance("fact")

    assert pm.run_once() == ["fact"] == jpm.run_once()
    after = shard_imbalance(sc.get("fact"))
    assert after < before / 2  # the hot key spread round-robin
    assert after == jax_shard_imbalance(jsc.get("fact"))
    assert sc.get("fact").partition_key is None  # no longer placed by k
    np.testing.assert_array_equal(sc.get("fact").counts, np.asarray(jsc.get("fact").counts))

    # queries over the migrated placement: the same answers, now through a
    # two-phase aggregate (the table is no longer placed by its group key)
    dq2 = DistributedQuery(_plan(cat), sc)
    assert_tables_equal(dq2.run().rows(), ref.rows(), ordered=False, rel_tol=1e-9)
    assert "exchange.gather" in [label for label, _ in dq2._sites]
    # a balanced load migrates nothing
    pm.observe(dq2)
    assert pm.run_once() == []
    assert pm.migrations == ["fact"]


def test_placement_without_hot_keys_rehashes():
    """An observed imbalance with no heavy hitter re-partitions by hash."""
    cat, sc, _, _ = _envs()
    pm = PlacementManager(cat, sc, imbalance_threshold=-1.0)
    t = Table([Column.from_numpy("k", DataType.INT64, np.arange(800, dtype=np.int64),
                                 device="cpu")], 800, name="even")
    cat.add_table("even", t)
    sc.add_sharded("even", t, "k")
    dq = DistributedQuery(Aggregate(GetTable("even", cat), [], [("n", ast.count_())]), sc)
    assert dq.run().rows() == [(800,)]
    pm.observe(dq)
    assert pm.run_once() == ["even"]
    assert sc.get("even").partition_key == "k"
    assert DistributedQuery(Aggregate(GetTable("even", cat), [], [("n", ast.count_())]),
                            sc).run().rows() == [(800,)]

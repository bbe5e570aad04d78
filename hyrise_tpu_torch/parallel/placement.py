"""Runtime-feedback placement: observe the shards' load, migrate hot tables.

Port of hyrise_tpu/parallel/placement.py (reference: NUMAPlacementManager,
src/lib/storage/numa_placement_manager.hpp:25-75, a collect-measure-migrate
loop over ChunkAccessCounters, chunk_access_counter.hpp:24-41). The nodes
are the mesh's shards; the access counters are fed from each
DistributedQuery's `source_rows()` (every sharded table it read, with the
rows each shard holds of it). When a table's recency-weighted load is more
imbalanced than the threshold, the manager re-partitions it from the
unsharded source (hot keys round-robin, skew.split_hot_keys; otherwise a
fresh hash partition) and swaps the new ShardedTable into the
ShardedCatalog, so every later query runs on the balanced placement.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np

from hyrise_tpu_torch.parallel.partition import (ShardedTable, hash_partition,
                                                 partition_by_targets)
from hyrise_tpu_torch.parallel.skew import detect_hot_keys, split_hot_keys

# reference defaults, numa_placement_manager.hpp:30-36
IMBALANCE_THRESHOLD = 0.1
MIGRATION_COUNT = 3
COUNTER_HISTORY_RANGE = 7


class AccessCounter:
    """Decaying per-shard load history (the ChunkAccessCounter ring)."""

    def __init__(self, n_shards: int, history: int = COUNTER_HISTORY_RANGE):
        self.ring: deque = deque(maxlen=history)
        self.n_shards = n_shards

    def record(self, per_shard_rows) -> None:
        self.ring.append(np.asarray(per_shard_rows, dtype=np.float64))

    def load(self) -> np.ndarray:
        """Recency-weighted per-shard load (the newest observation weighs
        most)."""
        if not self.ring:
            return np.zeros(self.n_shards)
        w = 2.0 ** np.arange(len(self.ring))
        return sum(wi * obs for wi, obs in zip(w, self.ring))

    def imbalance(self) -> float:
        load = self.load()
        if load.sum() <= 0:
            return 0.0
        return float(load.max() / max(load.mean(), 1e-9) - 1.0)


class PlacementManager:
    """collect_measure_and_migrate over a ShardedCatalog.

        pm = PlacementManager(catalog, shard_cat)
        dq = DistributedQuery(plan, shard_cat); out = dq.run()
        pm.observe(dq)              # pull the load signal
        migrated = pm.run_once()    # migrate up to migration_count tables
    """

    def __init__(self, catalog, shard_cat, imbalance_threshold: float = IMBALANCE_THRESHOLD,
                 migration_count: int = MIGRATION_COUNT, history: int = COUNTER_HISTORY_RANGE):
        self.catalog = catalog          # the unsharded source tables
        self.shard_cat = shard_cat
        self.threshold = imbalance_threshold
        self.migration_count = migration_count
        self.history = history
        self.counters: Dict[str, AccessCounter] = {}
        self.migrations: List[str] = []

    def observe(self, dq) -> None:
        """Charge every sharded table a finished query read with the rows
        each shard gave it (access frequency x shard size, what the
        reference's counters accumulate)."""
        for name, rows in dq.source_rows().items():
            st = self.shard_cat.get(name)
            if isinstance(st, ShardedTable):
                self.counters.setdefault(name, AccessCounter(st.n_shards, self.history)) \
                    .record(rows)

    def imbalance(self, name: str) -> float:
        c = self.counters.get(name)
        return c.imbalance() if c is not None else 0.0

    def run_once(self) -> List[str]:
        """One migration cycle: re-partition the most imbalanced sharded
        tables whose load exceeds the threshold, at most migration_count."""
        cands = sorted(((self.imbalance(n), n) for n in self.counters), reverse=True)
        migrated = []
        for imb, name in cands[:self.migration_count]:
            if imb <= self.threshold:
                break
            st = self.shard_cat.get(name)
            if not isinstance(st, ShardedTable) or st.partition_key is None:
                continue
            source = self.catalog.get_table(name)
            hot = detect_hot_keys(source, st.partition_key, st.n_shards)
            if len(hot):
                # hot keys spread over the shards: the table is no longer
                # placed by this key (partition_key None makes the
                # distributed executor shuffle instead of assuming locality)
                targets = split_hot_keys(source, st.partition_key, hot, st.n_shards)
                new_st = partition_by_targets(source, targets, st.mesh, partition_key=None)
            else:
                new_st = hash_partition(source, st.partition_key, st.mesh)
            new_st.name = name
            self.shard_cat.entries[name] = new_st
            self.counters.pop(name, None)  # a fresh history after migration
            self.migrations.append(name)
            migrated.append(name)
        return migrated

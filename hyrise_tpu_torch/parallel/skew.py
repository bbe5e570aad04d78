"""Skew detection and mitigation for hash-partitioned tables.

Port of hyrise_tpu/parallel/skew.py (the successor of the reference's
NUMAPlacementManager, src/lib/storage/numa_placement_manager.hpp:25-75,
imbalance_threshold 0.1). The imbalance axis is the shards' row counts.
Mitigations: `split_hot_keys` routes the rows of heavy-hitter keys
round-robin instead of by hash (the build side of a join then replicates
those keys to every shard, parallel/dist_compiler.py); placement.py
re-partitions a table whose observed load is imbalanced.

Hot keys are counted with torch.unique on the keys' device; a sharded
table's keys are gathered from every shard first (one all_gather over a
process group, so every rank reaches the same list), and the list is kept
on the ShardedTable.
"""

from __future__ import annotations

import numpy as np
import torch

from hyrise_tpu_torch import native
from hyrise_tpu_torch.parallel.exchange import all_gather
from hyrise_tpu_torch.parallel.partition import ShardedTable
from hyrise_tpu_torch.storage.table import Table

IMBALANCE_THRESHOLD = 0.1  # reference default (numa_placement_manager.hpp)
MAX_HOT_KEYS = 64


def shard_imbalance(st: ShardedTable) -> float:
    """max/mean - 1 over the shards' row counts (0 = perfectly even)."""
    counts = st.counts.astype(np.float64)
    if counts.sum() == 0:
        return 0.0
    return float(counts.max() / max(counts.mean(), 1.0) - 1.0)


def _hot_from_keys(keys: torch.Tensor, n_shards: int, factor: float,
                   max_keys: int = MAX_HOT_KEYS) -> np.ndarray:
    """Keys held by more than max(factor * rows / n_shards / 16, 8) rows,
    at most the `max_keys` heaviest (ties as the JAX package breaks them)."""
    n = keys.shape[0]
    uniq, counts = torch.unique(keys, return_counts=True)
    hot = counts > max(factor * n / max(n_shards, 1) / 16, 8)
    if int(hot.sum()) <= max_keys:
        return uniq[hot].cpu().numpy()
    uniq, counts, hot = uniq.cpu().numpy(), counts.cpu().numpy(), hot.cpu().numpy()
    keep = np.zeros(len(uniq), dtype=bool)
    keep[np.argsort(-counts)[:max_keys]] = True
    return uniq[hot & keep]


def detect_hot_keys(table: Table, key_col: str, n_shards: int,
                    factor: float = 4.0) -> np.ndarray:
    """Keys whose row count exceeds factor * (rows / n_shards) / 16 (and 8):
    they overload any single shard regardless of hash quality."""
    from hyrise_tpu_torch.ops.materialize import ensure_prefix

    table = ensure_prefix(table)
    return _hot_from_keys(table.column(key_col).data[:table.num_rows], n_shards, factor)


def detect_hot_keys_sharded(st: ShardedTable, key_col: str, factor: float = 4.0) -> np.ndarray:
    """Hot keys of a hash-partitioned table over all its shards; found once
    per (column, factor) and kept on the table."""
    cached = st.hot_keys.get((key_col, factor))
    if cached is None:
        keys = all_gather(st.mesh, [[t.column(key_col).data] for t in st.shards])[0][0]
        cached = _hot_from_keys(keys, st.n_shards, factor)
        st.hot_keys[(key_col, factor)] = cached
    return cached


def needs_rebalance(st: ShardedTable, threshold: float = IMBALANCE_THRESHOLD) -> bool:
    return shard_imbalance(st) > threshold


def split_hot_keys(table: Table, key_col: str, hot_keys: np.ndarray,
                   n_shards: int) -> np.ndarray:
    """Salted routing targets: normal rows by hash(key), hot-key rows
    round-robin. Returns a per-row target array for
    partition.partition_by_targets (a join's build side must then hold the
    hot keys on every shard)."""
    from hyrise_tpu_torch.ops.materialize import ensure_prefix

    table = ensure_prefix(table)
    keys = table.column(key_col).data[:table.num_rows].cpu().numpy().astype(np.int64)
    targets = native.hash_partition(keys, n_shards)
    if len(hot_keys):
        hot = np.isin(keys, hot_keys)
        targets[hot] = np.arange(int(hot.sum())) % n_shards
    return targets

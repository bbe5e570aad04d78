"""Hash-partitioned (sharded) tables.

Port of hyrise_tpu/parallel/partition.py (the successor of the reference's
per-NUMA-node chunk placement, src/lib/storage/numa_placement_manager.hpp:
25-75). Rows go to shard hash(key) % n_shards at ingest, routed on the host
by the native library (native.hash_partition, native.radix_route), so the
placement is the JAX package's by construction; queries that join or group
on the partition key then run with no exchange.

A shard is a port Table of exactly its rows, on its shard's device: the JAX
package's `[n_shards, shard_capacity]` layout exists for XLA's static
shapes, and the eager operators want a Table. Every shard keeps the
table-global metadata of each column (dictionary, unique, val_range): a
shard's rows are a subset of the table's, so a global bound and global
uniqueness hold in it too. A process holds only its own shards (all of them
in one process, one over a process group); `counts` holds every shard's
rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hyrise_tpu_torch import native
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.parallel.mesh import Mesh
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType


@dataclasses.dataclass
class ShardedColumn:
    """One column over this process's shards. Mirrors every public field
    of storage.column.Column: the payload fields (`data`, `validity`,
    `device`, `capacity`) are lists with one entry per local shard, the
    metadata fields are the table-global values every shard keeps.
    `encoded` stays None: shards are dense."""

    name: str
    dtype: DataType
    data: List[torch.Tensor]
    validity: Optional[List[Optional[torch.Tensor]]]
    dictionary: Optional[np.ndarray]
    encoded: Optional[object] = None
    unique: bool = False
    val_range: Optional[tuple] = None
    device: Optional[List[torch.device]] = None
    capacity: Optional[List[int]] = None


class ShardedTable:
    """`shards`: this process's shard Tables, in mesh.local_shards order;
    `counts`: rows of every shard (int64, on the host)."""

    def __init__(self, shards: List[Table], counts: np.ndarray, mesh: Mesh, name: str = "",
                 partition_key: Optional[str] = None):
        self.shards = shards
        self.counts = np.asarray(counts, dtype=np.int64)
        self.num_rows = int(self.counts.sum())
        self.mesh = mesh
        self.name = name
        self.partition_key = partition_key
        # hot keys per (column, factor), found once: parallel/skew.py
        self.hot_keys: dict = {}

    @property
    def n_shards(self) -> int:
        return len(self.counts)

    @property
    def device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.shards[0].device

    @property
    def column_names(self) -> List[str]:
        return self.shards[0].column_names

    def column(self, name: str) -> ShardedColumn:
        cols = [t.column(name) for t in self.shards]
        c = cols[0]
        validity = [x.validity for x in cols] if any(x.has_validity for x in cols) else None
        return ShardedColumn(c.name, c.dtype, [x.data for x in cols], validity, c.dictionary,
                             unique=c.unique, val_range=c.val_range,
                             device=[x.device for x in cols], capacity=[x.capacity for x in cols])

    def nbytes(self) -> int:
        """Bytes of this process's shard tensors (data and validity)."""
        return sum(x.numel() * x.element_size() for t in self.shards for c in t.columns
                   for x in (c.data, c.validity) if x is not None)


def hash_partition(table: Table, key_col: str, mesh: Mesh) -> ShardedTable:
    """Partition a table by the hash of an integer key column (float keys
    are truncated to int64, as the JAX package does)."""
    table = ensure_prefix(table)
    key = table.column(key_col).data[:table.num_rows].cpu().numpy().astype(np.int64)
    target = native.hash_partition(key, mesh.n_shards)
    return partition_by_targets(table, target, mesh, key_col)


def partition_by_targets(table: Table, target: np.ndarray, mesh: Mesh,
                         partition_key: Optional[str] = None) -> ShardedTable:
    """Partition by an explicit per-row shard target (the custom-router
    form: hot-key splitting and migration, parallel/placement.py). Each
    local shard gathers its rows, in table order, with one index_select a
    column on the table's device, and moves them to its own."""
    table = ensure_prefix(table)
    n = mesh.n_shards
    counts, order = native.radix_route(np.asarray(target, dtype=np.int32)[:table.num_rows], n)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    order_dev = torch.from_numpy(order).to(table.device)
    shards = []
    for s, dev in zip(mesh.local_shards, mesh.devices):
        idx = order_dev[int(offsets[s]):int(offsets[s + 1])]
        cols = []
        for c in table.columns:
            data = c.data.index_select(0, idx).to(dev)
            validity = c.validity.index_select(0, idx).to(dev) if c.has_validity else None
            cols.append(Column(c.name, c.dtype, data, validity, c.dictionary,
                               unique=c.unique, val_range=c.val_range))
        shards.append(Table(cols, len(idx), name=table.name))
    return ShardedTable(shards, counts, mesh, name=table.name, partition_key=partition_key)

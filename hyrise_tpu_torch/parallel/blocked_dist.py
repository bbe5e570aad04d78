"""Blocked streaming over sharded tables.

Port of hyrise_tpu/parallel/blocked_dist.py (the reference's chunk axis
times its NUMA axis: numa_placement_manager.hpp:25-75 distributes chunks,
and every operator iterates chunks, chunk.hpp:44). The plan's dominant
sharded table streams in row blocks: block b is rows [b * block_rows,
(b + 1) * block_rows) of every shard at once. The split is plan/blocked.py's:
the plan below its top-level Aggregate runs per block with the aggregate in
its partial form, and the partials are merged and finished once. The
port's validate_stream_path refuses a UnionAll on the stream path (ROADMAP
C1; the JAX file's accepts it).

Two forms:

- eager (the default): each pass runs one block a shard, views of the
  shard's tensors (Table.block), through DistributedQuery with its
  exchanges over block-sized intermediates. The operators off the stream
  path run once a run, not once a block: their outputs, exchanges
  included, are kept from the first block to the last.
- `compiled=True`, the JAX form (a DistributedCompiledQuery subclass
  there): plan/blocked.py's window design, one window a shard. The stream
  leaf reads a window of `block_rows` rows of each shard (the columns the
  block program references), whose row count is a 0-dim tensor; before
  each replay the block's rows of every shard are copied in on the stream
  the replay runs on. ONE captured block program, a DistributedCompiledQuery
  of the partial plan, serves every block of every shard; its decisions
  are pinned by an eager run over block 0. Each replay's partial goes into
  per-block buffers with its device counts, the host reads the stacked
  counts once after the last block, an overflow raises a site to its
  maximum across blocks (and captures again), and the capacities shrink to
  that maximum after a run. The operators off the stream path run inside
  the block program, in every block, as in the JAX form (`builds` counts
  the build sides its joins make a run). The merge is a CompiledQuery over
  the per-block buffers.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.parallel.dist_compiler import (DistributedCompiledQuery, DistributedQuery,
                                                     ShardedCatalog, gather_replicated)
from hyrise_tpu_torch.parallel.partition import ShardedTable
from hyrise_tpu_torch.plan.blocked import (_TAIL_OPS, PlanNotCompilable, _BlockPartials,
                                           _decompose, _materialized, _walk, referenced_columns,
                                           validate_stream_path)
from hyrise_tpu_torch.plan.compiler import tracing
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import JoinMode


class BlockedDistributedQuery(DistributedQuery, _BlockPartials):
    """DistributedQuery over row blocks of one sharded stream table.

        bq = BlockedDistributedQuery(plan, shard_cat, block_rows=1 << 20)
        table = bq.run()   # n_blocks passes, then the merge

    With `compiled=True` one captured block program serves every block
    (module docstring); `caps`, `last_retries`, `host_reads`, `captures`,
    `replays`, `pool_mb`, `builds`, `launches_captured` and
    `launches_replayed` then describe the last run, as
    plan/blocked.py's BlockedCompiledQuery's do.
    """

    MAX_RETRIES = DistributedCompiledQuery.MAX_RETRIES

    def __init__(self, root, shard_cat: ShardedCatalog, stream_table: Optional[str] = None,
                 block_rows: int = 1 << 20, exchange: str = "all_to_all",
                 compiled: bool = False):
        if block_rows < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._orig_root = root
        self._mode = "agg"
        parent, node = None, root
        while node.name in _TAIL_OPS and len(node.inputs) == 1:
            parent, node = node, node.inputs[0]
        if not isinstance(node, Aggregate):
            raise PlanNotCompilable("blocked distributed execution needs a top-level "
                                    f"Aggregate (found {node.name})")
        self._tail_parent = parent
        self._orig_agg = node
        partial_specs, self._final_specs, self._finish_cols = _decompose(node.aggregates)
        self._groupby = list(node.groupby)
        super().__init__(Aggregate(node.inputs[0], node.groupby, partial_specs), shard_cat,
                         exchange)
        sharded = [s for s in self._sources if isinstance(s, ShardedTable)]
        if stream_table is not None:
            sharded = [s for s in sharded if s.name == stream_table]
            if not sharded:
                raise PlanNotCompilable(f"no sharded source named {stream_table}")
        if not sharded:
            raise PlanNotCompilable("no sharded source to stream")
        self._stream = max(sharded, key=lambda s: int(s.counts.max()))
        leaves = [op for op in self.ops if isinstance(op, GetTable)
                  and self.shard_cat.get(op.table_name) is self._stream]
        if len(leaves) != 1:
            raise PlanNotCompilable(f"stream table {self._stream.name} referenced "
                                    f"{len(leaves)} times")
        self._leaf = leaves[0]
        path = validate_stream_path(self.ops, self._leaf, self.root)
        self._on_path = {id(op) for op in path}
        self.block_rows = block_rows
        self.n_blocks = self._block_count()
        self._lo = 0
        self.compiled = compiled
        if compiled:
            self.catalog = None
            self._init_partials()
            self.last_retries = self.host_reads = 0
            self.builds = 0
            self._path_joins = sum(
                isinstance(op, Join) and id(op.inputs[1 if op.mode is not JoinMode.RIGHT else 0])
                not in self._on_path for op in path)
            names: Optional[set] = set()
            for op in self.ops:
                refs = referenced_columns(op)
                names = None if refs is None or names is None else names | refs
            self._window_names = names
            self.lock = threading.RLock()
            self._pin_windows()
            self._block_cq = _BlockProgram(self)

    def _block_count(self) -> int:
        # the same window on every shard: as many blocks as the largest needs
        return max(-(-int(self._stream.counts.max()) // self.block_rows), 1)

    def _source(self, op, src):
        if op is not self._leaf:
            return super()._source(op, src)
        return ([t.block(min(self._lo, t.num_rows), min(self._lo + self.block_rows, t.num_rows))
                 for t in src.shards], self._src_placement[id(src)])

    def run(self, tighten: bool = False):
        """Every block through the stream path, the partials merged and
        finished on this process's first device. `tighten` (compiled form)
        shrinks the merge's capacities to its counts, as CompiledQuery.run
        does."""
        if self.compiled:
            return self._run_compiled(tighten)
        self._sites = []
        self.op_rows = {}
        self._local_sorted = set()
        kept = {}
        partials = []
        off_path = frozenset(id(op) for op in self.ops if id(op) not in self._on_path)
        for b in range(self.n_blocks):
            self._lo = b * self.block_rows
            out = self._execute(dict(kept), keep=off_path)
            kept = {k: v for k, v in out.items() if k in off_path}
            t, p = out[id(self.root)]
            if not p.replicated:
                t = gather_replicated(self.mesh, t, self._sites)
            partials.append(_materialized(t))
        merge, merged = self._merge_plan(partials)
        try:
            with self._grafted(merged):
                return execute_plan(merge)
        finally:
            for op in _walk(self._orig_root) + _walk(merge):
                op.clear_output()

    # -- the compiled form ---------------------------------------------------

    def _pin_windows(self) -> None:
        """A window of `block_rows` rows on every local shard of the stream
        table, over the columns the block program references."""
        rows = max(min(self.block_rows, int(self._stream.counts.max())), 1)
        self._windows, self._window_sources = [], []
        for t in self._stream.shards:
            dev = t.device
            pairs = [(Column(c.name, c.dtype, torch.zeros(rows, dtype=c.data.dtype, device=dev),
                             None if not c.has_validity else
                             torch.zeros(rows, dtype=torch.bool, device=dev), c.dictionary,
                             unique=c.unique, val_range=c.val_range), c)
                     for c in t.columns
                     if self._window_names is None or c.name in self._window_names]
            if not pairs:  # the plan reads no column by name (COUNT(*))
                c = t.columns[0]
                pairs = [(Column(c.name, c.dtype, torch.zeros(rows, dtype=c.data.dtype,
                                                              device=dev)), c)]
            self._windows.append(Table([w for w, _ in pairs],
                                       torch.zeros((), dtype=torch.int64, device=dev),
                                       name=t.name))
            self._window_sources.append(pairs)

    def _fill(self, b: int) -> None:
        """Block b of every shard into its window, and its rows into the
        window's row count: copies on the current stream, which the next
        replay runs on, from offsets the host knows."""
        lo = b * self.block_rows
        for window, pairs, t in zip(self._windows, self._window_sources, self._stream.shards):
            k = max(min(lo + self.block_rows, t.num_rows) - lo, 0)
            for dst, src in pairs:
                if k:
                    dst.data[:k].copy_(src.data[lo:lo + k])
                    if dst.validity is not None:
                        dst.validity[:k].copy_(src.validity[lo:lo + k])
            window.num_rows.fill_(k)

    def _refresh(self) -> None:
        """A stream table replaced in the ShardedCatalog since the last run
        gets windows of its own; the block program pins its sources anew."""
        now = self.shard_cat.get(self._stream.name)
        if now is not self._stream:
            self._stream = now
            self.n_blocks = self._block_count()
            self._pin_windows()
        self._block_cq.refresh_sources()

    def _run_compiled(self, tighten: bool):
        with self.lock:
            self._refresh()
            cq = self._block_cq
            cq.last_retries = cq.host_reads = 0
            for _ in range(self.MAX_RETRIES):
                if not self._pass(cq):
                    continue
                self.builds = self._path_joins * self.n_blocks
                out = self._merge(tighten)
                self.last_retries = cq.last_retries + self._merge_cq.last_retries
                self.host_reads = cq.host_reads + self._merge_cq.host_reads
                return out
            raise RuntimeError("capacity retry limit exceeded: "
                               + str(list(zip(cq.labels, cq.caps))))

    def exchange_stats(self):
        if self.compiled:
            return self._block_cq.exchange_stats()
        return super().exchange_stats()

    @property
    def sync_checked(self) -> bool:
        return self._block_cq.sync_checked


class _WindowedQuery(DistributedQuery):
    """The block program's executor: its stream leaf reads the windows in
    capacity mode, and block 0 of every shard in the eager run that pins
    the decisions (the eager blocked form decides in its block 0)."""

    def __init__(self, owner: BlockedDistributedQuery):
        super().__init__(owner.root, owner.shard_cat, owner.exchange)
        self._owner = owner

    def _source(self, op, src):
        o = self._owner
        if op is not o._leaf:
            return super()._source(op, src)
        if tracing():
            return list(o._windows), self._src_placement[id(src)]
        return ([t.block(0, min(o.block_rows, t.num_rows)) for t in src.shards],
                self._src_placement[id(src)])


class _BlockProgram(DistributedCompiledQuery):
    """The partial plan of a compiled BlockedDistributedQuery over its
    windows."""

    def __init__(self, owner: BlockedDistributedQuery):
        self._owner = owner
        super().__init__(owner.root, owner.shard_cat, owner.exchange)

    def _new_query(self) -> DistributedQuery:
        return _WindowedQuery(self._owner)

"""Blocked streaming over sharded tables.

Port of hyrise_tpu/parallel/blocked_dist.py (the reference's chunk axis
times its NUMA axis: numa_placement_manager.hpp:25-75 distributes chunks,
and every operator iterates chunks, chunk.hpp:44). The plan's dominant
sharded table streams in row blocks: block b is rows [b * block_rows,
(b + 1) * block_rows) of every shard at once, views of the shard's tensors
(Table.block), so each pass runs one block a shard through
DistributedQuery with its exchanges over block-sized intermediates. The
split is plan/blocked.py's: the plan below its top-level Aggregate runs per
block with the aggregate in its partial form, and the partials are merged
and finished once.

The port's validate_stream_path refuses a UnionAll on the stream path
(ROADMAP C1; the JAX file's accepts it). The operators off the stream path
run once a run, not once a block: their outputs, exchanges included, are
kept from the first block to the last.
"""

from __future__ import annotations

from typing import Optional

from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.parallel.dist_compiler import (DistributedQuery, ShardedCatalog,
                                                     gather_replicated)
from hyrise_tpu_torch.parallel.partition import ShardedTable
from hyrise_tpu_torch.plan.blocked import (_TAIL_OPS, PlanNotCompilable, _decompose,
                                           _materialized, _union_tree, _walk,
                                           validate_stream_path)


class BlockedDistributedQuery(DistributedQuery):
    """DistributedQuery over row blocks of one sharded stream table.

        bq = BlockedDistributedQuery(plan, shard_cat, block_rows=1 << 20)
        table = bq.run()   # n_blocks passes, then the merge
    """

    def __init__(self, root, shard_cat: ShardedCatalog, stream_table: Optional[str] = None,
                 block_rows: int = 1 << 20, exchange: str = "all_to_all"):
        if block_rows < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._orig_root = root
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
        # the same window on every shard: as many blocks as the largest needs
        self.n_blocks = max(-(-int(self._stream.counts.max()) // block_rows), 1)
        self._lo = 0

    def _source(self, op, src):
        if op is not self._leaf:
            return super()._source(op, src)
        return ([t.block(min(self._lo, t.num_rows), min(self._lo + self.block_rows, t.num_rows))
                 for t in src.shards], self._src_placement[id(src)])

    def run(self):
        """Every block through the stream path (the rest once), the partials
        materialized, merged and finished on this process's first device."""
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
        return self._merge_and_finish(partials)

    def _merge_and_finish(self, partials):
        """UnionAll of the partials -> final aggregate -> the AVG finisher ->
        the original tail, grafted onto the merged result for this call."""
        node = _union_tree([TableWrapper(t) for t in partials])
        final = Aggregate(node, self._groupby, self._final_specs)
        merged = Projection(final, list(self._groupby) + self._finish_cols)
        if self._tail_parent is None:
            return execute_plan(merged)
        self._tail_parent.inputs[0] = merged
        try:
            return execute_plan(self._orig_root)
        finally:
            self._tail_parent.inputs[0] = self._orig_agg
            for op in _walk(self._orig_root):
                op.clear_output()


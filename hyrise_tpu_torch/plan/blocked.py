"""Blocked (streaming) execution: one table of a plan processed in row
blocks through the eager operator DAG, partial aggregates merged at the
end.

Counterpart of the JAX package's plan/blocked.py (BlockedCompiledQuery).
The reference processes arbitrarily large tables chunk-at-a-time: every
operator iterates Chunks of at most Chunk::MAX_SIZE rows (reference:
src/lib/storage/chunk.hpp:44, table_scan.cpp per-chunk loops,
aggregate.cpp per-chunk maps merged at the end). The JAX form compiles one
block-shaped program over dynamic slices of device arrays; the port has no
compiled form (ROADMAP A, "not ported by decision") and runs the plan's own
operators once per block instead:

- the plan's dominant table (the largest source) is the STREAM table;
  every other table stays whole (dimension builds),
- the plan is split at its top-level Aggregate: the subtree below runs per
  block with the aggregate in its decomposable PARTIAL form (SUM / COUNT /
  MIN / MAX; AVG as SUM + COUNT), the reference's per-chunk map,
- the stream leaf is replaced, for the run, by a TableWrapper whose table
  is `Table.block(lo, hi)` of each block in turn: views of the tensors the
  table already has on its device, nothing copied (the JAX form's
  dynamic_slice of device arrays, blocked.py:207-265). Before each block
  only the operators on the stream path drop their outputs, so everything
  off it (dimension builds, resident subtrees) executes once a run, and a
  Join whose build input is off the path keeps its build side for the run
  (ops/join.py BuildCache): the reference builds its hash table once for
  all chunks (join_hash.cpp),
- partials are concatenated (UnionAll) and finished by a final aggregate
  and a projection that divides AVG's sums, then the original tail above
  the split (Sort / Projection / Limit / Alias / a HAVING TableScan) runs on
  the merged result.

Reduction-order policy: block partials fold in block order, so float sums
differ from the eager path's by the order of reduction only (ARCHITECTURE.md,
"Float policy across execution forms"); integers and strings are exact.

Supported shape: root = [tail ops]* -> Aggregate(subtree holding the
stream table exactly once), or a Limit(Sort(..)) root with no Aggregate
under it (per-block top K, merged by one more sort). Anything else raises
PlanNotCompilable; plan/segmented.py decomposes more plans into this shape.

Soundness: a block split is only correct when every output row of the
split subtree derives from exactly ONE stream-table row. The path from the
stream leaf to the split point may cross only row-distributive edges
(validate_stream_path). Unlike the JAX package (ROADMAP C1), a UnionAll on
the path is refused: its other input would be counted once per block.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from hyrise_tpu_torch.expression.ast import AggregateExpr, col
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.join import BuildCache, Join, Product
from hyrise_tpu_torch.ops.materialize import ensure_prefix, gather_table
from hyrise_tpu_torch.ops.misc import Limit, UnionAll
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.plan.compiler import PlanNotCompilable
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import EXISTENCE_MODES, AggregateFunction, DataType, JoinMode


# ops that may sit between the root and the split Aggregate; they run on the
# merged result, so a TableScan here is exactly a HAVING filter over the
# finished groups (reference: translated HAVING becomes a scan above the
# aggregate, lqp_translator.cpp predicate chain)
_TAIL_OPS = ("Sort", "Projection", "Limit", "Alias", "TableScan")

# single-input ops whose every output row derives from exactly one input
# row (filters / column rewrites): always safe to stream through
_ROW_DISTRIBUTIVE_1IN = ("TableScan", "Projection", "Alias", "Validate", "Materialize")


def _walk(root):
    """The operators under `root`, each once, inputs before consumers."""
    seen, order = set(), []

    def rec(op):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.inputs:
            rec(i)
        order.append(op)

    rec(root)
    return order


def _decompose(aggregates):
    """original (name, AggregateExpr) list ->
    (partial_specs, final_specs, finish_cols) for two-phase execution."""

    partial_specs: List[Tuple[str, object]] = []
    final_specs: List[Tuple[str, object]] = []
    finish_cols: List[object] = []  # str passthrough or (name, expr)
    F = AggregateFunction
    for name, ae in aggregates:
        if getattr(ae, "distinct", False):
            raise PlanNotCompilable(
                f"blocked execution: {name} is DISTINCT (not decomposable)")
        if ae.fn is F.AVG:
            s, c = name + "__bsum", name + "__bcnt"
            partial_specs += [(s, AggregateExpr(F.SUM, ae.arg)),
                              (c, AggregateExpr(F.COUNT, ae.arg))]
            final_specs += [(s, AggregateExpr(F.SUM, col(s))),
                            (c, AggregateExpr(F.SUM, col(c)))]
            # AVG is FLOAT64 whatever the input type (aggregate_result_type);
            # without the cast an INT64 sum / INT64 count truncates
            finish_cols.append((name, col(s).cast(DataType.FLOAT64) / col(c)))
        elif ae.fn in (F.SUM, F.COUNT):
            partial_specs.append((name, ae))
            final_specs.append((name, AggregateExpr(F.SUM, col(name))))
            finish_cols.append(name)
        elif ae.fn in (F.MIN, F.MAX):
            partial_specs.append((name, ae))
            final_specs.append((name, AggregateExpr(ae.fn, col(name))))
            finish_cols.append(name)
        else:
            raise PlanNotCompilable(f"blocked execution: {ae.fn} not decomposable")
    return partial_specs, final_specs, finish_cols


def leaf_table(op):
    """The table a GetTable or TableWrapper leaf gives, else None."""

    if isinstance(op, GetTable):
        return op.catalog.get_table(op.table_name)
    if isinstance(op, TableWrapper):
        return op.table
    return None


def _materialized(t):
    """A block's partial result as dense tensors of its live rows only: a
    lazy column would keep the whole block it gathers from alive."""

    t = ensure_prefix(t)
    if t.capacity > t.num_rows:
        t = gather_table(t, torch.arange(t.num_rows, device=t.device),
                         preserve_unique=True)
    for c in t.columns:
        c.data, c.validity  # noqa: B018 -- runs the gathers now
    return Table(t.columns, t.num_rows, name=t.name)


class BlockedQuery:
    """Counterpart of the JAX package's BlockedCompiledQuery: a plan over
    row blocks of one stream table.

    bq = BlockedQuery(TPCH_PLANS[1](cat), cat, block_rows=1 << 22)
    table = bq.run()   # n_blocks passes of the stream path, then the merge

    The caller's plan is left as it was after every run (its operators hold
    no outputs). `n_blocks` is the last run's block count and `builds` the
    number of build sides its joins made (BuildCache.builds).
    """

    def __init__(self, root, catalog, stream_table: Optional[str] = None,
                 block_rows: int = 1 << 22):

        if block_rows < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self.root = root
        self.catalog = catalog
        self.block_rows = block_rows
        self._mode = "agg"
        self._tail_parent = None
        # top-K per block is only row-distributive when each output row
        # derives from a single stream row: an Aggregate under the Sort
        # would surface a group split across blocks as duplicate keys with
        # partial values, so such roots take the aggregate split instead
        if isinstance(root, Limit) and isinstance(root.inputs[0], Sort) and \
                not any(isinstance(op, Aggregate) for op in _walk(root.inputs[0])):
            self._mode = "topk"
            self._topk_limit, self._topk_sort = root, root.inputs[0]
            self._block_root = root
        else:
            parent, node = None, root
            while node.name in _TAIL_OPS and len(node.inputs) == 1:
                parent, node = node, node.inputs[0]
            if not isinstance(node, Aggregate):
                raise PlanNotCompilable(
                    "blocked execution needs a top-level Aggregate or "
                    f"Limit(Sort(..)) root (found {node.name})")
            self._tail_parent = parent
            self._orig_agg = node
            partial_specs, self._final_specs, self._finish_cols = \
                _decompose(node.aggregates)
            self._groupby = list(node.groupby)
            self._block_root = Aggregate(node.inputs[0], node.groupby, partial_specs)

        ops = _walk(self._block_root)
        sources = [(op, leaf_table(op)) for op in ops]
        sources = [(op, t) for op, t in sources if t is not None]
        if stream_table is not None:
            # the catalog's table of that name, where the plan reads it: a
            # stage result bound to a placeholder may carry the same name
            stored = catalog.get_table(stream_table) \
                if catalog is not None and catalog.has_table(stream_table) else None
            cands = [t for _, t in sources if t is stored] or \
                [t for _, t in sources if t.name == stream_table]
            if not cands:
                raise PlanNotCompilable(f"no source named {stream_table}")
        else:
            cands = [t for _, t in sources]
        if not cands:
            raise PlanNotCompilable("blocked execution: the plan reads no table")
        self._stream = max(cands, key=lambda t: t.capacity)
        leaves = [op for op, t in sources if t is self._stream]
        if len(leaves) != 1:
            raise PlanNotCompilable(
                f"stream table {self._stream.name} referenced {len(leaves)} times "
                "(blocked execution is only row-distributive over a single "
                "occurrence)")
        self._leaf = leaves[0]
        terminal = () if self._mode == "agg" else (self._topk_sort, self._topk_limit)
        self._path = validate_stream_path(ops, self._leaf, self._block_root, terminal)
        if self._path[-1] is not self._block_root:  # top K: the path ends at the Sort
            self._path.append(self._block_root)
        self.n_blocks = self._block_count()
        self.builds = 0

    def _extent(self) -> int:
        """The stream table's positions that can hold a live row."""
        t = self._stream
        return t.num_rows if t.live is None else t.capacity

    def _block_count(self) -> int:
        # the last block is partial; an empty table still runs one empty block
        return max(-(-self._extent() // self.block_rows), 1)

    # -- the run -----------------------------------------------------------

    def run(self, context=None):
        """Every block through the stream path, then the merge. Raises
        whatever an operator raises, after putting the plan back."""

        wrapper = TableWrapper(None)
        rewired = []  # (op, input index) that read the stream leaf
        for op in _walk(self._block_root):
            for i, inp in enumerate(op.inputs):
                if inp is self._leaf:
                    op.inputs[i] = wrapper
                    rewired.append((op, i))
        path = [wrapper] + self._path[1:]
        on_path = {id(op) for op in path}
        cache = BuildCache()
        joins = []
        for op in path:
            if isinstance(op, Join):
                build = op.inputs[0] if op.mode is JoinMode.RIGHT else op.inputs[1]
                if id(build) not in on_path:
                    op.build_cache = cache
                    joins.append(op)
        self.n_blocks = self._block_count()
        try:
            partials = []
            extent = self._extent()
            for b in range(self.n_blocks):
                lo = b * self.block_rows
                wrapper.table = self._stream.block(lo, min(lo + self.block_rows, extent))
                for op in path:
                    op.clear_output()
                partials.append(_materialized(execute_plan(self._block_root, context)))
            self.builds = cache.builds
            for op in path:
                op.clear_output()
            wrapper.table = None
            if self._mode == "topk":
                return self._merge_topk(partials, context)
            return self._merge_and_finish(partials, context)
        finally:
            for op, i in rewired:
                op.inputs[i] = self._leaf
            for op in joins:
                op.build_cache = None
            cache.clear()
            for op in _walk(self.root) + _walk(self._block_root):
                op.clear_output()

    def _merge_topk(self, partials, context):
        """Per-block top-K tables (each the whole root over one block) ->
        their union (<= K x n_blocks rows) -> one final sort and limit."""

        node = _union_tree([TableWrapper(t) for t in partials])
        root = Limit(Sort(node, list(self._topk_sort.sort_defs)), self._topk_limit.n)
        return execute_plan(root, context)

    def _merge_and_finish(self, partials, context):
        """UnionAll of the partials -> final aggregate -> AVG-finisher
        projection -> the original tail ops, grafted onto the merged
        result for this call only."""

        node = _union_tree([TableWrapper(t) for t in partials])
        final = Aggregate(node, self._groupby, self._final_specs)
        merged = Projection(final, list(self._groupby) + self._finish_cols)
        if self._tail_parent is None:
            return execute_plan(merged, context)
        self._tail_parent.inputs[0] = merged
        try:
            return execute_plan(self.root, context)
        finally:
            self._tail_parent.inputs[0] = self._orig_agg


def _union_tree(nodes):
    """Balanced UnionAll fold of the partials, in block order."""

    while len(nodes) > 1:
        nxt = [UnionAll(nodes[i], nodes[i + 1]) for i in range(0, len(nodes) - 1, 2)]
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def validate_stream_path(ops, leaf, stop, terminal_nodes=()) -> list:
    """Refuse decompositions where blocking the stream table changes the
    result: the path from the stream leaf `leaf` up to the split point
    `stop` may cross only row-distributive edges (module docstring). The
    reference has no analogue: its chunk loops always see the WHOLE other
    side (join_hash.cpp builds over all chunks); here the split subtree
    sees one block at a time, so e.g. a per-block semi join against a
    blocked build side would emit a probe row once for every block it
    matches. `terminal_nodes` are treated as part of the split point (the
    top-K root's Sort and Limit). Returns the path, leaf first."""

    parents = {}
    for op in ops:
        for inp in op.inputs:
            parents.setdefault(id(inp), []).append(op)
    node, path = leaf, [leaf]
    while node is not stop and node not in terminal_nodes:
        ps = parents.get(id(node), [])
        if len(ps) != 1:
            raise PlanNotCompilable(
                f"blocked execution: stream-path node {node.name} has {len(ps)} "
                "consumers (a shared stream subtree would pair rows only within a "
                "block)")
        p = ps[0]
        path.append(p)
        if p is stop or p in terminal_nodes or p.name in _ROW_DISTRIBUTIVE_1IN \
                or isinstance(p, Product):
            node = p
            continue
        if isinstance(p, Join):
            side = 0 if p.inputs[0] is node else 1
            mode = p.mode
            ok = (mode is JoinMode.INNER
                  or (mode is JoinMode.LEFT and side == 0)
                  or (mode is JoinMode.RIGHT and side == 1)
                  or (mode in EXISTENCE_MODES and side == 0))
            if not ok:
                raise PlanNotCompilable(
                    "blocked execution: the stream table feeds the "
                    f"{'build' if side else 'preserved'} side of a {mode.value} join; "
                    f"per-block {mode.value} against a blocked side is not "
                    "row-distributive (would over/under-count matches)")
            node = p
            continue
        # UnionAll too (ROADMAP C1): its other input would be counted once
        # per block
        raise PlanNotCompilable(
            f"blocked execution: {p.name} on the stream path is not "
            "row-distributive (each output row must derive from exactly one "
            "stream row)")
    return path

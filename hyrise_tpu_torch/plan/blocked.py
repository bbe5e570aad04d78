"""Blocked (streaming) execution: one table of a plan processed in row
blocks, partial aggregates merged at the end.

Counterpart of the JAX package's plan/blocked.py. The reference processes
arbitrarily large tables chunk-at-a-time: every operator iterates Chunks of
at most Chunk::MAX_SIZE rows (reference: src/lib/storage/chunk.hpp:44,
table_scan.cpp per-chunk loops, aggregate.cpp per-chunk maps merged at the
end). Both forms here split a plan the same way:

- the plan's dominant table (the largest source) is the STREAM table;
  every other table stays whole (dimension builds),
- the plan is split at its top-level Aggregate: the subtree below runs per
  block with the aggregate in its decomposable PARTIAL form (SUM / COUNT /
  MIN / MAX; AVG as SUM + COUNT), the reference's per-chunk map,
- partials are concatenated (UnionAll) and finished by a final aggregate
  and a projection that divides AVG's sums, then the original tail above
  the split (Sort / Projection / Limit / Alias / a HAVING TableScan) runs on
  the merged result.

`BlockedQuery` (eager) runs the plan's own operators once per block: the
stream leaf is replaced, for the run, by a TableWrapper whose table is
`Table.block(lo, hi)` of each block in turn, views of the tensors the table
already has on its device. Before each block only the operators on the
stream path drop their outputs, so everything off it (dimension builds,
resident subtrees) executes once a run, and a Join whose build input is off
the path keeps its build side for the run (ops/join.py BuildCache): the
reference builds its hash table once for all chunks (join_hash.cpp).

`BlockedCompiledQuery` (the JAX name) runs ONE captured block program for
every block (plan/compiler.py). A CUDA graph reads the tensors it was
captured over, so the stream leaf reads a WINDOW table of `block_rows` rows
of each column the block program references (with validity and the live
mask where the stream table has them) whose row count is a 0-dim tensor on
the device; before each replay the block's rows are copied into the window
and its count filled in, on the stream the replay runs on, from offsets
the host knows. The JAX form passes the whole columns and cuts each block inside its
program with a traced offset (blocked.py:207-266); the window costs one more
read and write of the referenced columns and keeps every operator's input a
plain table. Each replay's outputs (the block's partial, at its capacity,
with its device count) are copied into per-block buffers kept across runs,
with no host read between blocks; after the last block the host reads the
stacked counts once. An overflow raises a site to the bucket of its maximum
across blocks and runs every block again (capturing again); after a run the
capacities shrink to the across-block maximum for the next one, never to a
single block's count. The off-path subtrees run inside the block program, in
every block, as in the JAX form (its builds per run are `builds`). The
merge (UnionAll tree, final Aggregate, AVG finisher, tail) is a
CompiledQuery over the per-block buffers, kept while their shapes hold: its
graph reads the new partials and their device counts in every run. A
steady run reads the host twice: the stacked counts and the merge's.

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

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

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
from hyrise_tpu_torch.plan.compiler import CompiledQuery, PlanNotCompilable, bucket_capacity
from hyrise_tpu_torch.storage.column import Column
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


def referenced_columns(op) -> Optional[set]:
    """Column names this operator reads from its inputs, or None when the
    set cannot be determined statically (consume-everything ops: UnionAll /
    UnionPositions / Difference / Print, an Alias that renames by position,
    any operator not listed)."""
    names = set()
    n = op.name
    if n == "TableScan":
        names |= set(op.predicate.columns())
    elif n == "Projection":
        for spec in op.outputs:
            if isinstance(spec, str):
                names.add(spec)
            else:
                names |= set(spec[1].columns())
    elif n == "Sort":
        names |= {c for c, _ in op.sort_defs}
    elif n in ("Join", "JoinHash", "JoinSortMerge", "JoinIndex", "JoinMPSM",
               "JoinNestedLoop"):
        for a, b in getattr(op, "column_pairs", [(op.left_col, op.right_col)]):
            names |= {a, b}
    elif n == "Alias":
        if op.sources is None:
            return None  # renames by POSITION: pruning would shift the columns
        names |= set(op.sources)
    elif n == "Aggregate":
        names |= set(op.groupby)
        for _, agg in op.aggregates:
            if agg.arg is not None:
                names |= set(agg.arg.columns())
    elif n in ("Limit", "Materialize", "Validate", "GetTable", "TableWrapper",
               "Product"):
        pass  # row ops and leaves read no column by name (a pruned hoisted
        # side of a Product simply carries fewer columns; only sound when the
        # keep set covers every reader downstream)
    else:
        return None
    return names


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


class _Merge:
    """The merge of per-block partials: their UnionAll, then the final
    aggregate, the AVG finisher and the original tail (or, for top K, one
    more sort and limit). The host class sets `_mode` ("agg" or "topk"),
    `_orig_root`, `_tail_parent`, `_orig_agg`, `_groupby`, `_final_specs`
    and `_finish_cols` (top K: `_topk_sort`, `_topk_limit`)."""

    def _merge_plan(self, partials):
        """(the plan over the partial tables that gives the result, the node
        the tail above the split reads during it, or None)."""
        node = _union_tree([TableWrapper(t) for t in partials])
        if self._mode == "topk":
            return self._merge_topk(node), None
        return self._merge_and_finish(node)

    def _merge_topk(self, union):
        """Per-block top-K tables (each the whole root over one block) ->
        their union (<= K x n_blocks rows) -> one final sort and limit."""
        return Limit(Sort(union, list(self._topk_sort.sort_defs)), self._topk_limit.n)

    def _merge_and_finish(self, union):
        """UnionAll of the partials -> final aggregate -> AVG-finisher
        projection, under the original tail: (the root to run, the
        projection the tail reads)."""
        final = Aggregate(union, self._groupby, self._final_specs)
        merged = Projection(final, list(self._groupby) + self._finish_cols)
        if self._tail_parent is None:
            return merged, None
        return self._orig_root, merged

    @contextlib.contextmanager
    def _grafted(self, merged):
        """The tail above the split reads `merged` instead of the original
        Aggregate, until the block leaves (nothing where `merged` is None)."""
        if merged is None:
            yield
            return
        self._tail_parent.inputs[0] = merged
        try:
            yield
        finally:
            self._tail_parent.inputs[0] = self._orig_agg


class _BlockSplit(_Merge):
    """What both blocked forms decide about a plan before they run it: the
    split (aggregate or top K), the stream table, its leaf, the stream path,
    and the merge plan over the partials."""

    def __init__(self, root, catalog, stream_table: Optional[str], block_rows: int):
        if block_rows < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self.root = root
        self._orig_root = root
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
        on_path = {id(op) for op in self._path}
        # the joins of the stream path whose build input every block shares
        self._shared_builds = [
            op for op in self._path if isinstance(op, Join)
            and id(op.inputs[0] if op.mode is JoinMode.RIGHT else op.inputs[1]) not in on_path]
        self.n_blocks = self._block_count()
        self.builds = 0

    def _extent(self) -> int:
        """The stream table's positions that can hold a live row."""
        t = self._stream
        return t.num_rows if t.live is None else t.capacity

    def _block_count(self) -> int:
        # the last block is partial; an empty table still runs one empty block
        return max(-(-self._extent() // self.block_rows), 1)

    @contextlib.contextmanager
    def _rewired(self, wrapper):
        """The stream leaf's consumer reads `wrapper` instead, until the
        block leaves; the caller's plan is as it was afterwards."""
        rewired = []  # (op, input index) that read the stream leaf
        for op in _walk(self._block_root):
            for i, inp in enumerate(op.inputs):
                if inp is self._leaf:
                    op.inputs[i] = wrapper
                    rewired.append((op, i))
        try:
            yield
        finally:
            for op, i in rewired:
                op.inputs[i] = self._leaf

class BlockedQuery(_BlockSplit):
    """The eager form: a plan over row blocks of one stream table.

    bq = BlockedQuery(TPCH_PLANS[1](cat), cat, block_rows=1 << 22)
    table = bq.run()   # n_blocks passes of the stream path, then the merge

    The caller's plan is left as it was after every run (its operators hold
    no outputs). `n_blocks` is the last run's block count and `builds` the
    number of build sides its joins made (BuildCache.builds).
    """

    def __init__(self, root, catalog, stream_table: Optional[str] = None,
                 block_rows: int = 1 << 22):
        super().__init__(root, catalog, stream_table, block_rows)

    def run(self, context=None):
        """Every block through the stream path, then the merge. Raises
        whatever an operator raises, after putting the plan back."""

        wrapper = TableWrapper(None)
        path = [wrapper] + self._path[1:]
        cache = BuildCache()
        for op in self._shared_builds:
            op.build_cache = cache
        self.n_blocks = self._block_count()
        try:
            with self._rewired(wrapper):
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
            merge, merged = self._merge_plan(partials)
            with self._grafted(merged):
                return execute_plan(merge, context)
        finally:
            for op in self._shared_builds:
                op.build_cache = None
            cache.clear()
            for op in _walk(self.root) + _walk(self._block_root):
                op.clear_output()


class _BlockPartials(_Merge):
    """What both compiled blocked forms (this module's and
    parallel/blocked_dist.py's) share: one pass of every block through the
    captured block program (`_block_cq`) with one host read of the stacked
    counts, the per-block partial buffers, and the merge as a CompiledQuery
    over them. The host class gives `n_blocks`, `_block_cq`, `catalog` and
    `_fill(b)`, which puts block b into the block program's sources."""

    def _init_partials(self) -> None:
        self._merge_cq: Optional[CompiledQuery] = None
        self._partials: Optional[List[Table]] = None
        self._counts: Optional[torch.Tensor] = None  # (n_blocks, counts) of a pass
        # graph counters of merges since replaced
        self._retired = {"captures": 0, "replays": 0, "captured": {}, "replayed": {}}

    def _pass(self, cq: CompiledQuery) -> bool:
        """One pass of every block through the block program and one host
        read of their stacked counts; False after an overflow, which raised
        the overflowed sites to the across-block maximum."""
        self._fill(0)
        if cq.on_cuda and not cq.captured:
            # learn on block 0 (under the sync check), then capture
            if cq.learn(tighten=False) is None:
                return False
            cq.capture()
        for b in range(self.n_blocks):
            if b:
                self._fill(b)
            self._keep(b, cq.replay(), cq.output_meta)
        counts = cq.read_counts(self._counts)
        top = [max(row[i] for row in counts) for i in range(len(counts[0]))]
        if cq.grow(top):
            cq.drop_graph()
            return False
        caps = list(cq.caps)
        cq.shrink(top[:len(cq.labels)])
        if cq.caps != caps:
            cq.drop_graph()  # the next run captures at the tighter capacities
        return True

    def _keep(self, b: int, outputs, meta) -> None:
        """Block b's partial into its buffers, which outlive the replay:
        the live prefix at the output capacity (a top K's at the bucket of
        K), the device row count, and the block's counts."""
        datas, valids, counts = outputs
        rows = datas[0].shape[0]
        if self._mode == "topk":
            rows = min(rows, bucket_capacity(max(self._topk_limit.n, 1)))
        layout = [(d.dtype, v is not None) for d, v in zip(datas, valids)]
        if b == 0 and not self._fits(rows, layout, counts.shape[0]):
            self._allocate(rows, meta, layout, counts.shape[0], datas[0].device)
        part = self._partials[b]
        if not self._fits(rows, layout, counts.shape[0]):
            raise RuntimeError(f"block {b}'s partial differs in layout from block 0's")
        for c, d, v in zip(part.columns, datas, valids):
            c.data.copy_(d[:rows])
            if v is not None:
                c.validity.copy_(v[:rows])
        part.num_rows.copy_(counts[-1])
        self._counts[b].copy_(counts)

    def _fits(self, rows: int, layout, n_counts: int) -> bool:
        parts = self._partials
        return (parts is not None and len(parts) == self.n_blocks
                and parts[0].capacity == rows and self._counts.shape[1] == n_counts
                and [(c.data.dtype, c.validity is not None) for c in parts[0].columns]
                == layout)

    def _allocate(self, rows: int, meta, layout, n_counts: int, device) -> None:
        """Per-block partial buffers for this layout; the merge, whose graph
        read the old ones, is built anew over them."""
        self._partials = [
            Table([Column(m.name, m.dtype, torch.zeros(rows, dtype=dtype, device=device),
                          torch.zeros(rows, dtype=torch.bool, device=device) if valid
                          else None, m.dictionary, val_range=m.val_range)
                   for m, (dtype, valid) in zip(meta, layout)],
                  torch.zeros((), dtype=torch.int64, device=device), name="partial")
            for _ in range(self.n_blocks)]
        self._counts = torch.zeros((self.n_blocks, n_counts), dtype=torch.int64,
                                   device=device)
        if self._merge_cq is not None:
            r, m = self._retired, self._merge_cq
            r["captures"] += m.captures
            r["replays"] += m.replays
            for key, counts in (("captured", m.launches_captured),
                                ("replayed", m.launches_replayed)):
                for k, v in counts.items():
                    r[key][k] = r[key].get(k, 0) + v
        self._merge_cq = None
        self._merge_root, self._merged = self._merge_plan(self._partials)

    def _merge(self, tighten: bool):
        with self._grafted(self._merged):
            if self._merge_cq is None:
                self._merge_cq = CompiledQuery(self._merge_root, self.catalog)
            return self._merge_cq.run(tighten)

    # -- counters ----------------------------------------------------------

    def _queries(self) -> list:
        return [q for q in (self._block_cq, self._merge_cq) if q is not None]

    @property
    def caps(self) -> List[int]:
        return self._block_cq.caps

    @property
    def captures(self) -> int:
        return self._retired["captures"] + sum(q.captures for q in self._queries())

    @property
    def replays(self) -> int:
        return self._retired["replays"] + sum(q.replays for q in self._queries())

    @property
    def pool_mb(self) -> float:
        """Device memory the last captures of the block program and the
        merge reserved."""
        return sum(q.pool_mb for q in self._queries())

    def _summed(self, key: str, attr: str) -> Dict[str, int]:
        out = dict(self._retired[key])
        for q in self._queries():
            for k, v in getattr(q, attr).items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def launches_captured(self) -> Dict[str, int]:
        return self._summed("captured", "launches_captured")

    @property
    def launches_replayed(self) -> Dict[str, int]:
        return self._summed("replayed", "launches_replayed")


class BlockedCompiledQuery(_BlockSplit, _BlockPartials):
    """A CompiledQuery over row blocks of one stream table: one captured
    block program serves every block (module docstring).

    cq = BlockedCompiledQuery(TPCH_PLANS[1](cat), cat, block_rows=1 << 22)
    table = cq.run()   # first call: learn on block 0, capture, replay every
                       # block, merge; later calls: replays and two reads

    `block_rows` is the window's rows (at most the stream table's extent),
    `n_blocks` the last run's block count, `caps` the block program's
    capacities by site, `last_retries` the last run's overflow retries (the
    block program's and the merge's), `host_reads` its device->host reads
    of counts, `builds` the build sides its stream path's joins made (one
    per shared build and block: the block program builds them in every
    block). `captures`, `replays`, `pool_mb`, `launches_captured` and
    `launches_replayed` cover the block program and the merges, as
    CompiledQuery's do. On CPU tensors every block runs the capacity mode
    uncaptured, so the window, the partial buffers, the retries and the
    tightening are the code the card runs. The caller's plan is left as it
    was after every run. MVCC tables are refused (PlanNotCompilable)."""

    MAX_RETRIES = CompiledQuery.MAX_RETRIES

    def __init__(self, root, catalog=None, stream_table: Optional[str] = None,
                 block_rows: int = 1 << 22):
        super().__init__(root, catalog, stream_table, block_rows)
        self._requested_rows = block_rows
        names: Optional[set] = set()
        for op in _walk(self._block_root):
            refs = referenced_columns(op)
            if refs is None or names is None:
                names = None
            else:
                names |= refs
        # a top-K partial is the stream rows themselves: every column
        self._window_names = None if self._mode == "topk" else names
        self._wrapper = TableWrapper(None)
        self._window: Optional[Table] = None
        self._window_sources: List[Tuple[Column, Column]] = []  # (window, stream)
        self._init_partials()
        self.last_retries = 0
        self.host_reads = 0
        self.sync_checked = False
        self.lock = threading.RLock()
        self._pin_stream(self._stream)
        with self._rewired(self._wrapper):
            # the window and the other sources pinned, MVCC tables refused
            self._block_cq = CompiledQuery(self._block_root, catalog)

    # -- the window --------------------------------------------------------

    def _pin_stream(self, table: Table) -> None:
        """Stream `table` from now on: a window of its referenced columns,
        rows and (where it has one) live mask. The block program is
        captured anew over it."""
        if table.mvcc is not None:
            raise PlanNotCompilable("MVCC table " + table.name)
        self._stream = table
        self.block_rows = max(min(self._requested_rows, self._extent()), 1)
        rows, dev = self.block_rows, table.device
        pairs = []
        for c in table.columns:
            if self._window_names is not None and c.name not in self._window_names:
                continue
            dtype = c.dtype.torch_dtype if c.encoded is not None or c.is_lazy \
                else c.data.dtype
            validity = None if not c.has_validity else \
                torch.zeros(rows, dtype=torch.bool, device=dev)
            pairs.append((Column(c.name, c.dtype, torch.zeros(rows, dtype=dtype, device=dev),
                                 validity, c.dictionary, unique=c.unique,
                                 val_range=c.val_range), c))
        if not pairs:  # the plan reads no column by name (COUNT(*))
            c = table.columns[0]
            pairs.append((Column(c.name, c.dtype, torch.zeros(rows, dtype=c.dtype.torch_dtype,
                                                              device=dev)), c))
        live = None if table.live is None else torch.zeros(rows, dtype=torch.bool, device=dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        self._window = Table([w for w, _ in pairs], n, name=table.name, live=live)
        self._window_sources = pairs
        self._wrapper.table = self._window

    def _fill(self, b: int) -> None:
        """Block b's rows into the window and its live count into the
        window's row count: copies enqueued on the current stream, which the
        next replay runs on, from offsets the host knows (no host read)."""
        lo = b * self.block_rows
        k = max(min(lo + self.block_rows, self._extent()) - lo, 0)
        window = self._window
        if k:
            for dst, src in self._window_sources:
                part = src.block(lo, lo + k)
                dst.data[:k].copy_(part.data)
                if dst.validity is not None:
                    dst.validity[:k].copy_(part.validity)
        if window.live is None:
            window.num_rows.fill_(k)
            return
        window.live[:k].copy_(self._stream.live[lo:lo + k])
        window.live[k:] = False
        window.num_rows.copy_(window.live.sum())

    # -- the run -----------------------------------------------------------

    def _refresh(self) -> None:
        """A stream table replaced in the catalog since the last run gets a
        window of its own (and the block program a capture over it); a
        replaced dimension table is pinned anew by the block program."""
        now = leaf_table(self._leaf)
        if now is not self._stream:
            self._pin_stream(now)
        self._block_cq.refresh_sources()

    def run(self, tighten: bool = False):
        """Every block through the one block program, then the merge;
        `tighten` shrinks the merge's capacities to its counts, as
        CompiledQuery.run does (the block program's always shrink to the
        across-block maximum after a run)."""
        with self.lock, self._rewired(self._wrapper):
            self._refresh()
            cq = self._block_cq
            cq.last_retries = cq.host_reads = 0
            self.n_blocks = self._block_count()
            for _ in range(self.MAX_RETRIES):
                if not self._pass(cq):
                    continue
                self.sync_checked = cq.sync_checked
                self.builds = len(self._shared_builds) * self.n_blocks
                out = self._merge(tighten)
                self.last_retries = cq.last_retries + self._merge_cq.last_retries
                self.host_reads = cq.host_reads + self._merge_cq.host_reads
                return out
            raise RuntimeError("capacity retry limit exceeded: "
                               + str(list(zip(cq.labels, cq.caps))))

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

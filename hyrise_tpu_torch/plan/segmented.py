"""Segmented streaming execution: the general chunk axis for plans that one
blocked pass (plan/blocked.py) cannot stream.

Counterpart of the JAX package's plan/segmented.py, over the eager
operator DAG. The reference runs EVERY operator chunk-at-a-time over
arbitrarily large tables (reference: src/lib/storage/chunk.hpp:44
Chunk::MAX_SIZE, src/lib/operators/table_scan.cpp:92-159 per-chunk jobs,
aggregate.cpp:437-541 per-chunk maps merged at the end), so a query that
references the fact table several times, nests aggregates, or roots at a
join still scales past device memory. BlockedQuery streams exactly one
shape: tail* -> decomposable Aggregate over a single distributive stream
occurrence. This module decomposes everything else into STAGES of that
shape:

1.  large sources (tables of more than `resident_rows` rows) are streamed;
    everything else stays whole,
2.  a rewrite pass wraps the build side of semi/anti joins holding a large
    reference in a DISTINCT-key Aggregate (the same join: existence joins
    only consult key presence, and one surviving NULL key row keeps the
    NULL / NOT IN behaviour), so the large reference sits under a
    decomposable aggregate,
3.  extraction repeatedly picks a lowest Aggregate whose subtree holds
    exactly ONE large reference on a row-distributive path, extends it
    upward through cheap single-input tail ops (HAVING scans / projections
    / aliases), cuts it out of the plan as a stage, and puts a TableWrapper
    placeholder in its place that receives the stage's result,
4.  the final stage is the remaining root: blocked if a large reference
    remains, executed whole otherwise.

Stages run in dependency order, each kept on its stage across run()
calls. Eager (the default), a stage with a large reference runs as a
BlockedQuery, any other through execute_plan, and each run rebinds a
stage's result into the same placeholder. With `compiled=True` a stage with
a large reference runs as a BlockedCompiledQuery and any other as a
CompiledQuery (plan/compiler.py), as the JAX form's _build_cq makes them. A
later stage's graph reads the placeholder's tensors, so a result of the
same layout as the last run's (capacity, rows, columns, types, metadata) is
copied into them in place; any other result is bound anew and every later
stage's compiled query is dropped, to be captured again. The JAX form's
capacity seeds (dump_seed / load_seed) carry XLA's static shapes between
processes and are not ported: a capture lasts as long as its process.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from hyrise_tpu_torch.expression.ast import count_
from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.join import Join
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.plan.blocked import (_TAIL_OPS, BlockedCompiledQuery, BlockedQuery,
                                           PlanNotCompilable, _decompose, _walk, leaf_table,
                                           referenced_columns, validate_stream_path)
from hyrise_tpu_torch.plan.compiler import CompiledQuery
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import EXISTENCE_MODES

# single-input tail ops a segment is extended through after its split
# aggregate (a HAVING scan shrinks the materialized result; projections and
# aliases are free); Sort and Limit stay in the residual plan
_SEGMENT_TAIL_OPS = ("TableScan", "Projection", "Alias")


class _PruneTo(AbstractOperator):
    """Keep-list projection for hoisted-stage outputs: drops columns no
    operator outside the subtree mentions, so that later stages only
    gather the columns the plan reads. Row-preserving; the keep set
    intersects with the actual schema at execution."""

    name = "Materialize"

    def __init__(self, input_op, keep):
        super().__init__(input_op)
        self.keep = set(keep)

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        cols = [c for c in t.columns if c.name in self.keep]
        if not cols:
            return t
        return Table(cols, t.num_rows, name=t.name, live=t.live)


@dataclasses.dataclass
class _Stage:
    top: object                  # subplan root this stage materializes
    wrapper: Optional[object]    # placeholder receiving the result
    stream: Optional[str]        # stream table name (None: executed whole)
    # kept across runs: a BlockedQuery, or when compiled a
    # BlockedCompiledQuery or CompiledQuery
    query: Optional[object] = None


class SegmentedQuery:
    """Decompose-and-stream executor over an operator DAG.

    sq = SegmentedQuery(TPCH_PLANS[18](cat), cat, block_rows=1 << 22)
    table = sq.run()

    The plan is rewritten in place (existence-build DISTINCT wrap, segment
    cut-out): SegmentedQuery takes ownership of the DAG passed in. With
    `compiled=True` every stage runs as a compiled query (module
    docstring); a stage the compiled forms refuse raises PlanNotCompilable.
    """

    def __init__(self, root, catalog, block_rows: int = 1 << 22,
                 resident_rows: int = 1 << 24,
                 stream_tables: Optional[List[str]] = None,
                 hoist_min_rows: int = 1 << 18, compiled: bool = False):
        self.root = root
        self.compiled = compiled
        self.lock = threading.RLock()
        self.catalog = catalog
        self.block_rows = block_rows
        self.resident_rows = resident_rows
        self._stream_tables = stream_tables
        self.hoist_min_rows = hoist_min_rows
        self._rewrite_existence_builds()
        self.stages: List[_Stage] = self._extract()
        self._hoist_stream_free()

    # -- plan analysis -----------------------------------------------------

    def _is_large(self, op) -> bool:
        t = leaf_table(op)
        if t is None:
            return False
        if self._stream_tables is not None:
            return t.name in self._stream_tables
        return t.capacity > self.resident_rows

    def _large_leaves(self, sub_root):
        return [op for op in _walk(sub_root) if self._is_large(op)]

    @staticmethod
    def _refs_of(sub_root, table) -> int:
        return sum(leaf_table(op) is table for op in _walk(sub_root))

    def _is_root_split(self, op, parents) -> bool:
        """True when `op` hangs under the root through BlockedQuery tail ops
        only, i.e. the final blocked stage would split exactly here, so
        extracting it as a stage of its own is pure overhead."""
        node = op
        while True:
            if node is self.root:
                return True
            ps = parents.get(id(node), [])
            if len(ps) != 1 or len(ps[0].inputs) != 1 or \
                    ps[0].name not in _TAIL_OPS:
                return False
            node = ps[0]

    # -- rewrite: existence-join builds ------------------------------------

    def _rewrite_existence_builds(self) -> None:
        """SEMI/ANTI joins only consult build-key PRESENCE, so a large build
        subtree can always be reduced through a DISTINCT-key aggregate,
        which extraction can then stream. Key multiplicity is irrelevant; a
        NULL key group survives as one row, keeping the NULL-never-matches
        and NOT IN rules (ops/join.py)."""

        for op in _walk(self.root):
            if isinstance(op, Join) and op.mode in EXISTENCE_MODES:
                build = op.inputs[1]
                if isinstance(build, Aggregate) or not self._large_leaves(build):
                    continue
                op.inputs[1] = Aggregate(build, [op.right_col], [("__exists_cnt", count_())])

    # -- extraction --------------------------------------------------------

    def _extract(self) -> List[_Stage]:

        stages: List[_Stage] = []
        while True:
            large = self._large_leaves(self.root)
            if not large:
                break
            parents: Dict[int, list] = {}
            for op in _walk(self.root):
                for inp in op.inputs:
                    parents.setdefault(id(inp), []).append(op)
            chosen = None
            for op in _walk(self.root):  # post-order: lowest first
                if not isinstance(op, Aggregate) or op is self.root:
                    continue
                sub_ops = _walk(op)
                in_sub = [leaf for leaf in large if leaf in sub_ops]
                if len(in_sub) != 1:
                    continue
                leaf = in_sub[0]
                if self._refs_of(op, leaf_table(leaf)) != 1:
                    continue
                try:
                    _decompose(op.aggregates)
                    validate_stream_path(sub_ops, leaf, op)
                except PlanNotCompilable:
                    continue
                if self._is_root_split(op, parents):
                    # this aggregate IS the final blocked stage's split
                    # point: leave it in place (one blocked pass beats a
                    # segment and a whole-plan tail)
                    continue
                chosen = (op, leaf)
                break
            if chosen is None:
                break  # the final stage handles (or refuses) the rest
            node, leaf = chosen
            # extend upward through cheap single-consumer tail ops
            while True:
                ps = parents.get(id(node), [])
                if len(ps) == 1 and ps[0] is not self.root \
                        and ps[0].name in _SEGMENT_TAIL_OPS and len(ps[0].inputs) == 1:
                    node = ps[0]
                    continue
                break
            if node is self.root or not parents.get(id(node)):
                break  # the remaining plan IS the segment: final stage
            wrapper = TableWrapper(None)
            for p in parents[id(node)]:
                p.inputs = [wrapper if i is node else i for i in p.inputs]
            stages.append(_Stage(node, wrapper, leaf_table(leaf).name))
        rest_large = self._large_leaves(self.root)
        final_stream = None
        if rest_large:
            final_stream = max((leaf_table(leaf) for leaf in rest_large),
                               key=lambda t: t.capacity).name
        stages.append(_Stage(self.root, None, final_stream))
        return stages

    # -- hoisting: stream-independent subtrees -----------------------------

    def _mentioned_outside(self, exclude_ops) -> Optional[set]:
        """Every column name read by an operator of a stage OUTSIDE
        `exclude_ops`: the safe keep set for pruning a hoisted subtree's
        result. None if any such operator's reads are not statically known
        (pruning is then skipped)."""
        excl = {id(o) for o in exclude_ops}
        mentioned: set = set()
        seen = set()
        for r in [s.top for s in self.stages] + [self.root]:
            for op in _walk(r):
                if id(op) in excl or id(op) in seen:
                    continue
                seen.add(id(op))
                names = referenced_columns(op)
                if names is None:
                    return None
                mentioned |= names
        return mentioned

    def _hoist_stream_free(self) -> None:
        """Cut every stream-free subtree that hangs off a blocked stage's
        stream path, and touches a table of at least `hoist_min_rows` rows,
        into a stage of its own that runs whole before it. The compiled
        block program (BlockedCompiledQuery, as the JAX package's) would
        repeat the subtree in every block; in the eager form it already
        runs once a run (BlockedQuery clears only the stream path's outputs
        between blocks), so there the cut changes no cost and keeps the
        stage lists those of the compiled form."""

        out: List[_Stage] = []
        for stage in self.stages:
            if stage.stream is None:
                out.append(stage)
                continue
            subs = _walk(stage.top)
            leaf = None
            for op in subs:
                t = leaf_table(op)
                if t is not None and t.name == stage.stream:
                    leaf = op
            if leaf is None:
                out.append(stage)
                continue
            parents: Dict[int, list] = {}
            for op in subs:
                for inp in op.inputs:
                    parents.setdefault(id(inp), []).append(op)
            path = {id(leaf)}
            node = leaf
            while node is not stage.top:
                ps = parents.get(id(node), [])
                if len(ps) != 1:
                    break
                node = ps[0]
                path.add(id(node))
            hoisted: Dict[int, object] = {}  # id(subtree) -> wrapper
            for op in subs:
                if id(op) not in path:
                    continue
                for i, inp in enumerate(op.inputs):
                    if id(inp) in path or isinstance(inp, (GetTable, TableWrapper)):
                        continue  # on the path, or already a whole table
                    caps = [t.capacity for leaf_op in _walk(inp)
                            for t in (leaf_table(leaf_op),) if t is not None]
                    if not caps or max(caps) < self.hoist_min_rows:
                        continue
                    w = hoisted.get(id(inp))
                    if w is None:
                        w = TableWrapper(None)
                        hoisted[id(inp)] = w
                        out.append(_Stage(self._maybe_prune(inp, stage.top), w, None))
                    op.inputs[i] = w
            out.append(stage)
        self.stages = out

    def _maybe_prune(self, sub_root, stage_top):
        """A hoisted subtree's result carries every column of its tables
        (comments, addresses) even when its consumer reads three of them.
        Wrap the subtree in a keep-list projection of every column name an
        operator outside it mentions, but only when (a) all outside reads
        are statically known and (b) every path from the subtree to its
        stage root crosses a column-enumerating op (Aggregate / Projection /
        source-named Alias), so a pruned column can never vanish from a
        final result."""
        mentioned = self._mentioned_outside(_walk(sub_root))
        if mentioned is None:
            return sub_root
        parents: Dict[int, list] = {}
        for op in _walk(stage_top):
            for inp in op.inputs:
                parents.setdefault(id(inp), []).append(op)

        def enumerating(op):
            return op.name in ("Aggregate", "Projection") or \
                (op.name == "Alias" and op.sources is not None)

        frontier, seen = [sub_root], set()
        while frontier:
            node = frontier.pop()
            for p in parents.get(id(node), []):
                if id(p) in seen:
                    continue
                seen.add(id(p))
                if enumerating(p):
                    continue
                if p is stage_top:
                    return sub_root  # a schema-carrying path: do not prune
                frontier.append(p)
        return _PruneTo(sub_root, mentioned)

    # -- execution ---------------------------------------------------------

    def _bind(self, stage: _Stage, result) -> None:
        """Hand a stage's result to its placeholder, the same TableWrapper
        on every run; the result is compacted to its live rows first. The
        eager operators pin nothing to the previous result, so there
        rebinding the placeholder's table is all a rerun needs. A compiled
        later stage read the previous result's tensors: a result of the
        same layout is copied into them, any other is bound anew and every
        later stage's compiled query is dropped (the JAX rule)."""

        result = ensure_prefix(result)
        dst = stage.wrapper.table
        if self.compiled and dst is not None:
            if _same_layout(dst, result):
                for a, b in zip(dst.columns, result.columns):
                    a.data.copy_(b.data)
                    if a.validity is not None:
                        a.validity.copy_(b.validity)
                return
            for later in self.stages[self.stages.index(stage) + 1:]:
                later.query = None
        stage.wrapper.table = result

    def _stage_query(self, stage: _Stage):
        """The query of a stage with a large reference, or of any stage when
        compiled, made at its first run (its placeholders are bound by
        then): when compiled, the JAX form's _build_cq."""
        if stage.query is None:
            if not self.compiled:
                stage.query = BlockedQuery(stage.top, self.catalog,
                                           stream_table=stage.stream,
                                           block_rows=self.block_rows)
            elif stage.stream is None:
                stage.query = CompiledQuery(stage.top, self.catalog)
            else:
                stage.query = BlockedCompiledQuery(stage.top, self.catalog,
                                                   stream_table=stage.stream,
                                                   block_rows=self.block_rows)
        return stage.query

    def run(self, context=None):
        """Every stage in order; the last one's result."""

        out = None
        with self.lock:
            for stage in self.stages:
                if self.compiled:
                    out = self._stage_query(stage).run()
                elif stage.stream is not None:
                    out = self._stage_query(stage).run(context)
                else:
                    # outputs a plan computed while it was built (a scalar
                    # subquery's) are used as execute_plan uses them; every
                    # output goes after the run, so that a rerun computes anew
                    try:
                        out = execute_plan(stage.top, context)
                    finally:
                        for op in _walk(stage.top):
                            op.clear_output()
                if stage.wrapper is not None:
                    self._bind(stage, out)
        return out

    def describe(self) -> str:
        lines = []
        whole = "compiled" if self.compiled else "whole"
        for i, s in enumerate(self.stages):
            kind = f"blocked[{s.stream}]" if s.stream else whole
            role = "final" if s.wrapper is None else "segment"
            lines.append(f"stage {i}: {role} {kind} root={s.top.name}")
        return "\n".join(lines)


def _same_layout(a: Table, b: Table) -> bool:
    """Whether `b` can be copied into `a`'s tensors with nothing a graph
    baked in changing: capacity, rows, and each column's name, types,
    validity, dictionary, uniqueness and value range."""
    if (a.capacity, a.num_rows, len(a.columns)) != (b.capacity, b.num_rows, len(b.columns)):
        return False
    for x, y in zip(a.columns, b.columns):
        if (x.name, x.dtype, x.data.dtype, x.validity is None, x.unique, x.val_range) != \
                (y.name, y.dtype, y.data.dtype, y.validity is None, y.unique, y.val_range):
            return False
        if x.dictionary is not y.dictionary and (
                x.dictionary is None or y.dictionary is None
                or not np.array_equal(x.dictionary, y.dictionary)):
            return False
    return True

"""LQP -> physical operator translation.

Port of hyrise_tpu/plan/translator.py. Reference:
src/lib/logical_query_plan/lqp_translator.cpp:68-246 — node-type dispatch;
join nodes pick JoinHash for hashable equi predicates and
SortMerge/NestedLoop otherwise; predicates become TableScan chains, and a
predicate the IndexScanRule marked becomes an IndexScan of the stored table.

An INNER equi JoinNode with column equalities between its two sides in the
PredicateNodes directly above it (the SQL translator keeps one equality as
the join key and the others as predicates) becomes one MultiKeyJoin on all
of them (ROADMAP C22): it joins on one packed key where the key ranges
allow, and the LQP is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from hyrise_tpu_torch.ops.aggregate import Aggregate
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.get_table import GetTable, TableWrapper
from hyrise_tpu_torch.ops.index_scan import IndexScan
from hyrise_tpu_torch.ops.join import Join, JoinSortMerge, MultiKeyJoin, Product
from hyrise_tpu_torch.ops.misc import (AddRowIds, Alias, Difference, Limit, UnionAll,
                                       UnionPositions)
from hyrise_tpu_torch.ops.projection import Projection
from hyrise_tpu_torch.ops.rw_ops import Delete, Insert, Update, Validate
from hyrise_tpu_torch.ops.sort import Sort
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.optimizer import _output_columns
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType, JoinMode, PredicateCondition


class _Maintenance(AbstractOperator):
    """CreateView/DropView/CreateTable/DropTable/ShowTables/ShowColumns
    executor (reference: operators/maintenance/*)."""

    def __init__(self, node, catalog):
        super().__init__()
        self.node = node
        self.catalog = catalog

    @property
    def name(self):
        return type(self.node).__name__

    def _on_execute(self, context):
        cat = self.catalog
        dev = cat.device
        n = self.node
        if isinstance(n, L.CreateViewNode):
            cat.add_view(n.view_name, n.lqp)
        elif isinstance(n, L.DropViewNode):
            cat.drop_view(n.view_name)
        elif isinstance(n, L.CreateTableNode):
            from hyrise_tpu_torch.concurrency.transaction import MvccData
            defs = n.column_definitions
            t = Table.from_arrays(
                n.table_name, defs,
                [np.array([], dtype=object) if d.dtype is DataType.STRING
                 else np.array([], dtype=d.dtype.numpy_dtype) for d in defs],
                device=dev)
            t.mvcc = MvccData.for_new_table(0, 0, device=dev)
            cat.add_table(n.table_name, t)
        elif isinstance(n, L.DropTableNode):
            cat.drop_table(n.table_name)
        elif isinstance(n, L.ShowTablesNode):
            return Table.from_arrays(
                "tables", [TableColumnDefinition("table_name", DataType.STRING)],
                [np.array(cat.table_names(), dtype=object)], device=dev)
        elif isinstance(n, L.ShowColumnsNode):
            t = cat.get_table(n.table_name)
            return Table.from_arrays(
                "columns",
                [TableColumnDefinition("column_name", DataType.STRING),
                 TableColumnDefinition("column_type", DataType.STRING),
                 TableColumnDefinition("is_nullable", DataType.INT32)],
                [np.array([c.name for c in t.columns], dtype=object),
                 np.array([c.dtype.value for c in t.columns], dtype=object),
                 np.array([int(c.validity is not None) for c in t.columns],
                          dtype=np.int32)], device=dev)
        # DDL succeeded: empty result
        return Table.from_arrays(
            "ok", [TableColumnDefinition("ok", DataType.INT32)],
            [np.array([], dtype=np.int32)], device=dev)


class _Distinct(Aggregate):
    """DISTINCT: group by every input column, no aggregates."""

    def _on_execute(self, context):
        self.groupby = self.input_table(0).column_names
        return super()._on_execute(context)


def _column_pair(predicate, left_cols, right_cols) -> Optional[Tuple[str, str]]:
    """(left column, right column) of a predicate that equates a column of
    each side of a join, else None."""
    if not (isinstance(predicate, ast.Comparison)
            and predicate.cond is PredicateCondition.EQUALS
            and isinstance(predicate.left, ast.ColumnRef)
            and isinstance(predicate.right, ast.ColumnRef)):
        return None
    a, b = predicate.left.name, predicate.right.name
    for x, y in ((a, b), (b, a)):
        if x in left_cols and y in right_cols and x not in right_cols and y not in left_cols:
            return x, y
    return None


def _fold_join(node: L.JoinNode, predicates: List[object], T, catalog):
    """(MultiKeyJoin, the predicates it did not take) when `node` is an INNER
    equi join and some of `predicates` (which sit directly above it, lowest
    first) equate a column of each side; else None."""
    if node.mode is not JoinMode.INNER or node.cond is not PredicateCondition.EQUALS:
        return None
    left_cols = _output_columns(node.children[0], catalog)
    right_cols = _output_columns(node.children[1], catalog)
    if left_cols is None or right_cols is None:
        return None
    folded, rest = [], []
    for p in predicates:
        pair = _column_pair(p, set(left_cols), set(right_cols))
        if pair is None:
            rest.append(p)
        else:
            folded.append((*pair, p))
    if not folded:
        return None
    return MultiKeyJoin(T(node.children[0]), T(node.children[1]),
                        (node.left_col, node.right_col), folded), rest


def _predicate_chain(node: L.LQPNode):
    """The predicates of the PredicateNodes from `node` down, lowest first,
    and the node below them."""
    preds = []
    while isinstance(node, L.PredicateNode):
        preds.append(node.predicate)
        node = node.children[0]
    return preds[::-1], node


def translate_lqp(node: L.LQPNode, catalog=None,
                  _memo: Optional[Dict[int, AbstractOperator]] = None
                  ) -> AbstractOperator:
    memo = _memo if _memo is not None else {}
    if id(node) in memo:
        return memo[id(node)]

    def T(n):
        return translate_lqp(n, catalog, memo)

    if isinstance(node, L.StoredTableNode):
        op: AbstractOperator = GetTable(node.table_name, catalog)
        if node.pruned_columns is not None:
            op = Projection(op, list(node.pruned_columns))
    elif isinstance(node, L.StaticTableNode):
        op = TableWrapper(node.table)
    elif isinstance(node, L.PredicateNode):
        use_composite = getattr(node, "use_index_composite", None)
        use_index = getattr(node, "use_index", None)
        if use_composite is not None or use_index is not None:
            # IndexScanRule marked the scan (plan/optimizer.py): read the
            # stored table itself, whose indexes it carries, then apply the
            # leaf's column pruning and alias on top
            leaf = node.children[0]
            stored = leaf.children[0] if isinstance(leaf, L.AliasNode) else leaf
            source = GetTable(stored.table_name, catalog)
            if use_composite is not None:
                column, value, extra = use_composite
                op = IndexScan(source, column, PredicateCondition.EQUALS, value,
                               extra_equals=extra)
            else:
                op = IndexScan(source, *use_index)
            if stored.pruned_columns is not None:
                op = Projection(op, list(stored.pruned_columns))
            if leaf is not stored:
                op = Alias(op, leaf.names, leaf.sources)
        else:
            preds, below = _predicate_chain(node)
            fold = _fold_join(below, preds, T, catalog) \
                if isinstance(below, L.JoinNode) else None
            if fold is None:
                op = TableScan(T(node.children[0]), node.predicate)
            else:
                op, rest = fold
                for p in rest:
                    op = TableScan(op, p)
    elif isinstance(node, L.ProjectionNode):
        op = Projection(T(node.children[0]), node.outputs)
    elif isinstance(node, L.AggregateNode):
        # Fusion pass (reference: JitAwareLQPTranslator,
        # jit_operator/jit_aware_lqp_translator.cpp): lower a maximal
        # Predicate* -> Aggregate chain into ONE filter + reduce operator
        # (kernel K6). FusedFilterAggregate builds TableScan + Aggregate
        # itself when the shape does not fit (non-dictionary group-by,
        # COUNT DISTINCT).
        from hyrise_tpu_torch.expression.ast import Logical
        from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate

        preds, c = _predicate_chain(node.children[0])
        fold = _fold_join(c, preds, T, catalog) if isinstance(c, L.JoinNode) else None
        below = None
        if fold is not None:
            below, preds = fold
        if preds:
            combined = preds[0]
            for p in preds[1:]:
                combined = Logical("and", combined, p)
            op = FusedFilterAggregate(T(c) if below is None else below, combined,
                                      node.groupby, node.aggregates)
        elif below is not None:
            op = Aggregate(below, node.groupby, node.aggregates)
        else:
            op = Aggregate(T(node.children[0]), node.groupby, node.aggregates)
    elif isinstance(node, L.DistinctNode):
        op = _Distinct(T(node.children[0]), [], [])
    elif isinstance(node, L.JoinNode):
        left, right = T(node.children[0]), T(node.children[1])
        if node.mode is JoinMode.CROSS:
            op = Product(left, right)
        elif node.cond is PredicateCondition.EQUALS:
            # reference picks JoinHash for hashable equi joins
            op = Join(left, right, node.mode, (node.left_col, node.right_col))
        else:
            op = JoinSortMerge(left, right, node.mode,
                               (node.left_col, node.right_col), node.cond)
    elif isinstance(node, L.SortNode):
        op = Sort(T(node.children[0]), node.sort_defs)
    elif isinstance(node, L.LimitNode):
        op = Limit(T(node.children[0]), node.n)
    elif isinstance(node, L.UnionNode):
        cls = UnionAll if node.kind == "all" else UnionPositions
        op = cls(T(node.children[0]), T(node.children[1]))
    elif isinstance(node, L.DifferenceNode):
        op = Difference(T(node.children[0]), T(node.children[1]))
    elif isinstance(node, L.AliasNode):
        op = Alias(T(node.children[0]), node.names, node.sources)
    elif isinstance(node, L.ValidateNode):
        op = Validate(T(node.children[0]))
    elif isinstance(node, L.AddRowIdsNode):
        op = AddRowIds(T(node.children[0]))
    elif isinstance(node, L.InsertNode):
        op = Insert(node.table_name, T(node.children[0]), catalog)
    elif isinstance(node, L.DeleteNode):
        op = Delete(node.table_name, T(node.children[0]), catalog)
    elif isinstance(node, L.UpdateNode):
        op = Update(node.table_name, T(node.children[0]), T(node.children[1]),
                    catalog)
    elif isinstance(node, (L.CreateViewNode, L.DropViewNode, L.CreateTableNode,
                           L.DropTableNode, L.ShowTablesNode,
                           L.ShowColumnsNode)):
        op = _Maintenance(node, catalog)
    else:
        raise NotImplementedError(f"cannot translate {type(node).__name__}")

    memo[id(node)] = op
    return op

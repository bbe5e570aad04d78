"""Logical query plan nodes.

Reference: src/lib/logical_query_plan/ — AbstractLQPNode DAG with 19 node
types (abstract_lqp_node.hpp:15-36). Python dataclasses; children are node
references (DAGs allowed for shared subplans, e.g. subselects).

Column identity is name-based (our physical layer resolves columns by name),
so the reference's LQPColumnReference machinery collapses to string names +
Alias nodes for disambiguation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from hyrise_tpu_torch.expression.ast import AggregateExpr, Expr
from hyrise_tpu_torch.types import JoinMode, PredicateCondition, SortMode


class LQPNode:
    children: List["LQPNode"]

    def describe(self, depth: int = 0) -> str:
        pad = "  " * depth
        parts = [f"{pad}{self!r}"]
        for c in self.children:
            parts.append(c.describe(depth + 1))
        return "\n".join(parts)


def _node(cls):
    cls = dataclasses.dataclass(eq=False, repr=False)(cls)
    return cls


@_node
class StoredTableNode(LQPNode):
    table_name: str
    pruned_columns: Optional[List[str]] = None  # set by ColumnPruningRule

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[StoredTable] {self.table_name}"


@_node
class StaticTableNode(LQPNode):
    """Literal/mock table (reference: MockNode / static_table_node)."""

    table: object

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[StaticTable] {getattr(self.table, 'name', '?')}"


@_node
class PredicateNode(LQPNode):
    predicate: Expr

    def __init__(self, predicate: Expr, child: LQPNode):
        self.predicate = predicate
        self.children = [child]

    def __repr__(self):
        return f"[Predicate] {self.predicate}"


@_node
class ProjectionNode(LQPNode):
    outputs: List[Union[str, Tuple[str, Expr]]]

    def __init__(self, outputs, child: LQPNode):
        self.outputs = list(outputs)
        self.children = [child]

    def __repr__(self):
        return f"[Projection] {[o if isinstance(o, str) else o[0] for o in self.outputs]}"


@_node
class AggregateNode(LQPNode):
    groupby: List[str]
    aggregates: List[Tuple[str, AggregateExpr]]

    def __init__(self, groupby, aggregates, child: LQPNode):
        self.groupby = list(groupby)
        self.aggregates = list(aggregates)
        self.children = [child]

    def __repr__(self):
        return f"[Aggregate] group={self.groupby} aggs={[n for n, _ in self.aggregates]}"


@_node
class JoinNode(LQPNode):
    mode: JoinMode
    left_col: Optional[str]
    right_col: Optional[str]
    cond: PredicateCondition

    def __init__(self, mode: JoinMode, left: LQPNode, right: LQPNode,
                 left_col: Optional[str] = None,
                 right_col: Optional[str] = None,
                 cond: PredicateCondition = PredicateCondition.EQUALS):
        self.mode = mode
        self.left_col = left_col
        self.right_col = right_col
        self.cond = cond
        self.children = [left, right]

    def __repr__(self):
        if self.mode is JoinMode.CROSS:
            return "[Join] cross"
        return (f"[Join] {self.mode.value} {self.left_col} "
                f"{self.cond.value} {self.right_col}")


@_node
class SortNode(LQPNode):
    sort_defs: List[Tuple[str, SortMode]]

    def __init__(self, sort_defs, child: LQPNode):
        self.sort_defs = [(d, SortMode.ASCENDING) if isinstance(d, str) else d
                          for d in sort_defs]
        self.children = [child]

    def __repr__(self):
        return f"[Sort] {self.sort_defs}"


@_node
class LimitNode(LQPNode):
    n: int

    def __init__(self, n: int, child: LQPNode):
        self.n = n
        self.children = [child]

    def __repr__(self):
        return f"[Limit] {self.n}"


@_node
class UnionNode(LQPNode):
    kind: str  # "all" | "positions"

    def __init__(self, kind: str, left: LQPNode, right: LQPNode):
        self.kind = kind
        self.children = [left, right]

    def __repr__(self):
        return f"[Union] {self.kind}"


@_node
class DifferenceNode(LQPNode):
    """Set difference by full-row equality (reference: difference.cpp)."""

    def __init__(self, left: LQPNode, right: LQPNode):
        self.children = [left, right]

    def __repr__(self):
        return "[Difference]"


@_node
class AliasNode(LQPNode):
    names: List[str]
    sources: Optional[List[str]]

    def __init__(self, names, child: LQPNode, sources=None):
        self.names = list(names)
        self.sources = list(sources) if sources is not None else None
        self.children = [child]

    def __repr__(self):
        return f"[Alias] {self.names}"


@_node
class ValidateNode(LQPNode):
    def __init__(self, child: LQPNode):
        self.children = [child]

    def __repr__(self):
        return "[Validate]"


@_node
class DistinctNode(LQPNode):
    """Realized as group-by over all columns (reference: DISTINCT handling
    in aggregate.cpp:443-472)."""

    def __init__(self, child: LQPNode):
        self.children = [child]

    def __repr__(self):
        return "[Distinct]"


@_node
class AddRowIdsNode(LQPNode):
    """Attach the row_id handle column (ops.rw_ops.AddRowIds) — the PosList
    handle DML plans need."""

    def __init__(self, child: LQPNode):
        self.children = [child]

    def __repr__(self):
        return "[AddRowIds]"


@_node
class InsertNode(LQPNode):
    table_name: str

    def __init__(self, table_name: str, values: LQPNode):
        self.table_name = table_name
        self.children = [values]

    def __repr__(self):
        return f"[Insert] {self.table_name}"


@_node
class DeleteNode(LQPNode):
    table_name: str

    def __init__(self, table_name: str, rows: LQPNode):
        self.table_name = table_name
        self.children = [rows]

    def __repr__(self):
        return f"[Delete] {self.table_name}"


@_node
class UpdateNode(LQPNode):
    table_name: str

    def __init__(self, table_name: str, rows: LQPNode, values: LQPNode):
        self.table_name = table_name
        self.children = [rows, values]

    def __repr__(self):
        return f"[Update] {self.table_name}"


@_node
class CreateViewNode(LQPNode):
    view_name: str
    lqp: LQPNode

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[CreateView] {self.view_name}"


@_node
class DropViewNode(LQPNode):
    view_name: str

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[DropView] {self.view_name}"


@_node
class CreateTableNode(LQPNode):
    table_name: str
    column_definitions: list

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[CreateTable] {self.table_name}"


@_node
class DropTableNode(LQPNode):
    table_name: str

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[DropTable] {self.table_name}"


@_node
class ShowTablesNode(LQPNode):
    def __init__(self):
        self.children = []

    def __repr__(self):
        return "[ShowTables]"


@_node
class ShowColumnsNode(LQPNode):
    table_name: str

    def __post_init__(self):
        self.children = []

    def __repr__(self):
        return f"[ShowColumns] {self.table_name}"


def map_lqp(node: LQPNode, fn) -> LQPNode:
    """Bottom-up rewrite: fn(node) -> replacement (or same node). Shared
    subplans are rewritten once."""
    seen = {}

    def walk(n: LQPNode) -> LQPNode:
        if id(n) in seen:
            return seen[id(n)]
        n.children = [walk(c) for c in n.children]
        out = fn(n)
        seen[id(n)] = out
        return out

    return walk(node)

"""IndexScan.

Port of hyrise_tpu/ops/index_scan.py (reference: src/lib/operators/
index_scan.{hpp,cpp}, chosen by the IndexScanRule where an index exists).
A binary search in the table's index (storage/index.py) gives a contiguous
range of its sorted permutation; the output is those rows, gathered lazily,
in the index's order. The literal is compared as TableScan compares it
(expression/evaluator.py comparison_rule), so the two give the same rows.

Conditions that are no single range (LIKE, IN, IS NULL, !=), a column
without an index, and equality conjuncts that no composite index covers
run as a TableScan of the same predicate.

In capacity mode (plan/compiler.py: a compiled, compiled-streamed or
compiled-distributed run) every IndexScan runs that TableScan, as in the
JAX CompiledQuery, whose traced tables carry no index: the rows come in
table order, `index_fallback` is set, and a captured graph reads no index
tensor, so an index created or replaced after the capture changes nothing.
"""

from __future__ import annotations

from hyrise_tpu_torch.expression.ast import (Between, ColumnRef, Comparison, Expr,
                                             InList, IsNull, Like, Literal, Logical)
from hyrise_tpu_torch.expression.evaluator import comparison_rule
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.ops.materialize import gather_table
from hyrise_tpu_torch.ops.table_scan import TableScan
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.index import SortedIndex, find_composite_index, get_index
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import PredicateCondition

P = PredicateCondition


class IndexScan(AbstractOperator):
    name = "IndexScan"

    # the conditions whose rows are one contiguous range of the index
    _RANGE_CONDS = (P.EQUALS, P.LESS_THAN, P.LESS_THAN_EQUALS, P.GREATER_THAN,
                    P.GREATER_THAN_EQUALS, P.BETWEEN)

    def __init__(self, input_op: AbstractOperator, column: str,
                 cond: PredicateCondition, value, value2=None, extra_equals=None):
        super().__init__(input_op)
        self.column = column
        self.cond = cond
        self.value = value
        self.value2 = value2  # BETWEEN's upper bound
        # further (column, value) equality conjuncts, served by a composite
        # index on (column, *their columns)
        self.extra_equals = list(extra_equals or [])

    def _on_execute(self, context) -> Table:
        from hyrise_tpu_torch.plan.compiler import tracing

        table = self.input_table(0)
        if tracing():
            # an index range is read on the host
            return self._table_scan_fallback(table, context)
        if self.extra_equals:
            if self.cond is P.EQUALS:
                out = self._composite_scan(table)
                if out is not None:
                    return out
            return self._table_scan_fallback(table, context)
        idx = get_index(table, self.column)
        if not isinstance(idx, SortedIndex) or self.cond not in self._RANGE_CONDS:
            # the rule selects IndexScan only where it applies; a wrong
            # choice is a slower scan, not an error
            return self._table_scan_fallback(table, context)
        c = table.column(self.column)
        if self.cond is P.BETWEEN:
            lo = self._range(idx, c, P.GREATER_THAN_EQUALS, self.value)
            hi = self._range(idx, c, P.LESS_THAN_EQUALS, self.value2)
            start, end = max(lo[0], hi[0]), min(lo[1], hi[1])
        else:
            start, end = self._range(idx, c, self.cond, self.value)
        end = max(start, end)
        self.performance_data.extra["index_range"] = (start, end)
        return gather_table(table, idx.perm[start:end], preserve_unique=True)

    @staticmethod
    def _range(idx: SortedIndex, c: Column, cond: PredicateCondition, value):
        """[start, end) of the index's rows that satisfy `c cond value`."""
        rule = comparison_rule(c, cond, value)
        if isinstance(rule, bool):
            return (0, idx.n_ordered) if rule else (0, 0)
        cond, v = rule
        lo, hi = idx.lookup(v)  # the first row >= v, the first > v
        return {P.EQUALS: (lo, hi), P.LESS_THAN: (0, lo), P.LESS_THAN_EQUALS: (0, hi),
                P.GREATER_THAN: (hi, idx.n_ordered),
                P.GREATER_THAN_EQUALS: (lo, idx.n_ordered)}[cond]

    def _composite_scan(self, table: Table):
        """The equality conjunction through a composite index whose columns
        start with the conjunction's; None when there is none."""
        pairs = [(self.column, self.value)] + self.extra_equals
        cidx = find_composite_index(table, [name for name, _ in pairs])
        if cidx is None:
            return None
        values = []
        for name, value in pairs:
            rule = comparison_rule(table.column(name), P.EQUALS, value)
            if rule is False:  # nothing equals the value
                values = None
                break
            values.append(rule[1])
        start, end = cidx.lookup_equals(values) if values is not None else (0, 0)
        self.performance_data.extra["index_range"] = (start, end)
        self.performance_data.extra["composite_index"] = cidx.columns
        return gather_table(table, cidx.perm[start:end], preserve_unique=True)

    def _table_scan_fallback(self, table: Table, context) -> Table:
        self.performance_data.extra["index_fallback"] = True
        return execute_plan(TableScan(TableWrapper(table), self._as_expr()), context)

    def _as_expr(self) -> Expr:
        col = ColumnRef(self.column)
        cond = self.cond
        if cond is P.BETWEEN:
            expr = Between(col, Literal(self.value), Literal(self.value2))
        elif cond in (P.LIKE, P.NOT_LIKE):
            expr = Like(col, self.value, negate=cond is P.NOT_LIKE)
        elif cond in (P.IS_NULL, P.IS_NOT_NULL):
            expr = IsNull(col, negate=cond is P.IS_NOT_NULL)
        elif cond in (P.IN, P.NOT_IN):
            values = self.value if isinstance(self.value, (list, tuple)) else [self.value]
            expr = InList(col, [Literal(v) for v in values], negate=cond is P.NOT_IN)
        else:
            expr = Comparison(cond, col, Literal(self.value))
        for name, value in self.extra_equals:
            expr = Logical("and", expr, Comparison(P.EQUALS, ColumnRef(name), Literal(value)))
        return expr

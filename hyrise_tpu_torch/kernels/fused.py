"""Fused scan -> aggregate operator.

Port of hyrise_tpu/kernels/fused.py (reference:
src/lib/operators/jit_operator/: JitReadTuples -> JitFilter -> JitCompute ->
JitAggregate over one fused per-tuple loop). `FusedFilterAggregate` replaces
TableScan -> Aggregate when every group-by column is a NULL-free dictionary
column and the group space (the product of the dictionary sizes: Q1's 3 x 2
cells) is at most DENSE_CELL_MAX. The predicate and the aggregate arguments
are evaluated as torch ops over the whole input; then ONE launch of the K6
kernel (kernels/fused_reduce.py) reads the mask, the code columns and each
distinct argument once and gives every count, sum, minimum and maximum per
cell. The input is never compacted.

Shapes that do not fit (a non-dictionary or nullable group key, COUNT
DISTINCT, MIN/MAX of a string, more cells) run TableScan -> Aggregate
instead; `fell_back` says so after execution.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.expression.ast import AggregateExpr, Expr
from hyrise_tpu_torch.expression.evaluator import compile_expression, make_env
from hyrise_tpu_torch.kernels.fused_reduce import MAX_KEYS, fused_cells_reduce
from hyrise_tpu_torch.kernels.prims import DENSE_CELL_MAX
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.ops.materialize import mask_to_indices
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import (AggregateFunction, DataType,
                                    aggregate_result_type)

_KINDS = {AggregateFunction.SUM: "sum", AggregateFunction.AVG: "sum",
          AggregateFunction.MIN: "min", AggregateFunction.MAX: "max",
          AggregateFunction.COUNT: "count"}


class FusedFilterAggregate(AbstractOperator):
    name = "FusedFilterAggregate"

    def __init__(self, input_op: AbstractOperator,
                 predicate: Optional[Expr],
                 groupby: Sequence[str],
                 aggregates: Sequence[Tuple[str, AggregateExpr]]):
        super().__init__(input_op)
        self.predicate = predicate
        self.groupby = list(groupby)
        self.aggregates = list(aggregates)
        # whether the last execution ran TableScan -> Aggregate instead
        self.fell_back: Optional[bool] = None

    def _cell_sizes(self, table: Table) -> Optional[List[int]]:
        """The dictionary sizes of the group-by columns, or None when the
        input does not fit the fused form."""
        if len(self.groupby) > MAX_KEYS:
            return None
        sizes, n_cells = [], 1
        for name in self.groupby:
            c = table.column(name)
            if c.dtype is not DataType.STRING or c.dictionary is None:
                return None
            if c.has_validity:
                # NULL group keys need their own group; the cell arithmetic
                # would merge them into dictionary[0]
                return None
            sizes.append(max(len(c.dictionary), 1))
            n_cells *= sizes[-1]
        if n_cells > DENSE_CELL_MAX:
            return None  # the general group-by is the high-cardinality path
        if any(agg.fn not in _KINDS for _, agg in self.aggregates):
            return None  # COUNT DISTINCT
        return sizes

    def _fallback(self, table: Table, context) -> Table:
        from hyrise_tpu_torch.ops.aggregate import Aggregate
        from hyrise_tpu_torch.ops.get_table import TableWrapper
        from hyrise_tpu_torch.ops.table_scan import TableScan

        self.fell_back = True
        src: AbstractOperator = TableWrapper(table)
        if self.predicate is not None:
            src = TableScan(src, self.predicate)
        return execute_plan(Aggregate(src, self.groupby, self.aggregates), context)

    def _on_execute(self, context) -> Table:
        table = self.input_table(0)
        sizes = self._cell_sizes(table)
        if sizes is None:
            return self._fallback(table, context)
        # (out_name, fn, argument's repr, compiled argument | None) per aggregate
        specs = []
        for out_name, agg in self.aggregates:
            ce = None if agg.arg is None else compile_expression(agg.arg, table)
            if ce is not None and ce.dtype is DataType.STRING and \
                    agg.fn is not AggregateFunction.COUNT:
                # string MIN/MAX carries its dictionary through the general path
                return self._fallback(table, context)
            specs.append((out_name, agg.fn, repr(agg.arg), ce))
        self.fell_back = False
        dev = table.device

        # `live` is the table's whole liveness mask, not a prefix length: a
        # masked layout has its live rows scattered through the capacity
        mask = None
        if self.predicate is not None:
            ce = compile_expression(self.predicate, table)
            d, v = ce.fn(make_env(table, ce.required))
            mask = d.to(torch.bool)
            if v is not None:
                mask = mask & v
        if table.has_dead_rows:
            live = table.live_mask()
            mask = live if mask is None else (mask & live)
        if mask is None:
            mask = torch.ones(table.capacity, dtype=torch.bool, device=dev)

        # one evaluation per distinct argument (Q1's SUM and AVG of
        # l_quantity share one sum)
        evaluated = {}
        slots = []
        for _, fn, key, ce in specs:
            if ce is None:  # COUNT(*)
                slots.append((None, None, "count"))
                continue
            if key not in evaluated:
                data, validity = ce.fn(make_env(table, ce.required))
                if ce.is_bool:
                    data = data.to(torch.int32)
                evaluated[key] = (data.contiguous(), validity)
            data, validity = evaluated[key]
            slots.append((data, validity, _KINDS[fn]))

        keys = [table.column(name).data.contiguous() for name in self.groupby]
        counts, results = fused_cells_reduce(mask.contiguous(), keys, sizes, slots)

        n_cells = counts.shape[0]
        if sizes:
            # ascending cell ids are key-sorted group order (codes preserve
            # order); reading their number is the host sync (an oracle site
            # in capacity mode)
            sel, n_groups = mask_to_indices(counts > 0, "aggregate.groups")
        else:
            sel = torch.zeros(1, dtype=torch.int64, device=dev)  # always one row
            n_groups = 1

        cols: List[Column] = []
        stride = n_cells
        for name, size in zip(self.groupby, sizes):
            stride //= size
            codes = (sel // stride) % size
            cols.append(Column(name, DataType.STRING, codes.to(torch.int32), None,
                               table.column(name).dictionary))
        for (out_name, fn, _, ce), (data, n_valid) in zip(specs, results):
            data = data.index_select(0, sel)
            n_valid = n_valid.index_select(0, sel)
            in_dt = DataType.INT64 if ce is None else ce.dtype
            out_dt = aggregate_result_type(fn, in_dt)
            if fn is AggregateFunction.AVG:
                data = data.to(torch.float64) / n_valid.clamp(min=1).to(torch.float64)
            valid = None
            if fn is not AggregateFunction.COUNT and ce is not None:
                # no valid input: SUM/MIN/MAX/AVG are NULL, not 0
                valid = n_valid > 0
            cols.append(Column(out_name, out_dt, data.to(out_dt.torch_dtype), valid))
        out = Table(cols, n_groups, name=table.name)
        if len(self.groupby) == 1:
            out.column(self.groupby[0]).unique = True  # each group appears once
        return out

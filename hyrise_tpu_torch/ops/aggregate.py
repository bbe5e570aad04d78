"""Group aggregate operator.

Port of the general branch of hyrise_tpu/ops/aggregate.py (reference:
src/lib/operators/aggregate.{hpp,cpp}). Group ids are sort-based: cluster
the live rows by the group key with one stable multi-key sort, mark
boundaries, prefix-sum to dense ids; each aggregate is then a segmented
reduction (kernels/prims.py). Output groups come in key order.

NULL semantics: NULLs form one group; aggregates skip NULL inputs;
SUM/MIN/MAX/AVG of zero valid rows is NULL; COUNT of zero rows is 0.

The JAX package's TPU tiers (_fast_scalar, _fast_dense, _fast_sorted) and
COUNT(DISTINCT) are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from hyrise_tpu_torch.expression.ast import AggregateExpr
from hyrise_tpu_torch.expression.evaluator import compile_expression, make_env
from hyrise_tpu_torch.kernels.prims import (compact_indices, segment_max,
                                            segment_min, segment_sum)
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix, gather_table
from hyrise_tpu_torch.ops.sort_util import group_boundaries, group_permutation
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import AggregateFunction, DataType, aggregate_result_type


class Aggregate(AbstractOperator):
    name = "Aggregate"

    def __init__(self, input_op: AbstractOperator, groupby: Sequence[str],
                 aggregates: Sequence[Tuple[str, AggregateExpr]]):
        super().__init__(input_op)
        self.groupby = list(groupby)
        self.aggregates = list(aggregates)

    def _on_execute(self, context) -> Table:
        # prefix layout: the live rows are the first num_rows
        table = ensure_prefix(self.input_table(0))
        n = table.num_rows
        dev = table.device
        out_cols: List[Column] = []
        if self.groupby:
            perm = group_permutation(table, self.groupby)
            flags = group_boundaries(table, self.groupby, perm)
            # dead rows sort last: keep the first n of every permuted array
            rows = perm[:n]
            gid = torch.cumsum(flags[:n].to(torch.int64), 0) - 1
            n_groups = int(gid[-1]) + 1 if n else 0
            # group-by key columns: representative = first row of each group
            rep = gather_table(table, rows.index_select(0, compact_indices(flags[:n])))
            for name in self.groupby:
                out_cols.append(rep.column(name))
        else:
            rows = torch.arange(n, device=dev)
            gid = torch.zeros(n, dtype=torch.int64, device=dev)
            n_groups = 1  # global aggregate: always one output row

        if not out_cols and not self.aggregates:
            raise ValueError("Aggregate with no group-by columns and no aggregates")
        for out_name, agg in self.aggregates:
            out_cols.append(self._compute_aggregate(table, agg, out_name, rows,
                                                    gid, n_groups))
        return Table(out_cols, n_groups, name=table.name)

    @staticmethod
    def _compute_aggregate(table: Table, agg: AggregateExpr, out_name: str,
                           rows: torch.Tensor, gid: torch.Tensor,
                           n_groups: int) -> Column:
        """One aggregate over the live rows `rows` (in group order), whose
        group ids are `gid`."""
        fn = agg.fn
        if fn is AggregateFunction.COUNT and agg.arg is None:
            counts = torch.bincount(gid, minlength=n_groups)
            return Column(out_name, DataType.INT64, counts)
        if fn is AggregateFunction.COUNT_DISTINCT:
            raise NotImplementedError("COUNT(DISTINCT) is not ported yet")

        ce = compile_expression(agg.arg, table)
        data, validity = ce.fn(make_env(table, ce.required))
        in_dt = ce.dtype
        if ce.is_bool:
            data = data.to(torch.int32)
        d = data.index_select(0, rows)
        v = (torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
             if validity is None else validity.index_select(0, rows))

        out_dt = aggregate_result_type(fn, in_dt)
        counts = segment_sum(v.to(torch.int64), gid, n_groups)
        nonempty = counts > 0

        if fn is AggregateFunction.COUNT:
            return Column(out_name, DataType.INT64, counts)

        if fn in (AggregateFunction.SUM, AggregateFunction.AVG):
            acc_dtype = torch.float64 if out_dt is DataType.FLOAT64 else torch.int64
            acc = torch.where(v, d.to(acc_dtype), torch.zeros((), dtype=acc_dtype,
                                                             device=d.device))
            sums = segment_sum(acc, gid, n_groups)
            if fn is AggregateFunction.SUM:
                return Column(out_name, out_dt, sums.to(out_dt.torch_dtype), nonempty)
            avg = sums.to(torch.float64) / counts.clamp(min=1).to(torch.float64)
            return Column(out_name, DataType.FLOAT64, avg, nonempty)

        if fn in (AggregateFunction.MIN, AggregateFunction.MAX):
            # reduce in int64 / float64 (exact for every input type; string
            # codes are order-preserving) and cast back to the result type
            if in_dt.is_floating:
                key = d.to(torch.float64)
                identity = float("inf") if fn is AggregateFunction.MIN else float("-inf")
            else:
                key = d.to(torch.int64)
                info = torch.iinfo(torch.int64)
                identity = info.max if fn is AggregateFunction.MIN else info.min
            masked = torch.where(v, key, torch.full((), identity, dtype=key.dtype,
                                                    device=key.device))
            reduce = segment_min if fn is AggregateFunction.MIN else segment_max
            red = reduce(masked, gid, n_groups, identity)
            if in_dt is DataType.STRING:
                return Column(out_name, DataType.STRING, red.to(torch.int32),
                              nonempty, ce.dictionary)
            return Column(out_name, out_dt, red.to(out_dt.torch_dtype), nonempty)

        raise NotImplementedError(fn)

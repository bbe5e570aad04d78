"""Group aggregate operator.

Port of hyrise_tpu/ops/aggregate.py (reference:
src/lib/operators/aggregate.{hpp,cpp}). The input picks one of two forms:

- dense cells: a global aggregate (one cell) or a group-by whose keys are
  all NULL-free dictionary columns spanning at most DENSE_CELL_MAX
  combinations. Each row's cell id is computed from its codes and every
  aggregate is one reduction into the cells (the K3 kernel,
  kernels/group_reduce.py). A masked-layout input is read through its live
  mask, never compacted. This is the JAX package's _fast_scalar and
  _fast_dense.
- general: any other group-by. Cluster the live rows by the group key with
  one stable multi-key sort, mark boundaries, prefix-sum to dense ids; each
  aggregate is then a segmented reduction (kernels/prims.py).

Output groups come in key order either way. The JAX package's third form
(_fast_sorted and its key packing) works around the TPU compiler and has no
counterpart.

NULL semantics: NULLs form one group; aggregates skip NULL inputs;
SUM/MIN/MAX/AVG of zero valid rows is NULL; COUNT of zero rows is 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.expression.ast import AggregateExpr
from hyrise_tpu_torch.expression.evaluator import compile_expression, make_env
from hyrise_tpu_torch.kernels.prims import (DENSE_CELL_MAX, compact_indices,
                                            segment_max, segment_min,
                                            segment_reduce_cells, segment_sum)
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix, gather_table
from hyrise_tpu_torch.ops.sort_util import (group_boundaries, group_permutation,
                                            lexsort)
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import AggregateFunction, DataType, aggregate_result_type


def _sentinel(dtype: torch.dtype, for_min: bool):
    """The identity of MIN (or MAX) in `dtype`."""
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _distinct_key(data: torch.Tensor, in_dt: DataType) -> torch.Tensor:
    if in_dt.is_integral or in_dt is DataType.STRING:
        return data.to(torch.int64)
    return data.to(torch.float64)


class Aggregate(AbstractOperator):
    name = "Aggregate"

    def __init__(self, input_op: AbstractOperator, groupby: Sequence[str],
                 aggregates: Sequence[Tuple[str, AggregateExpr]]):
        super().__init__(input_op)
        self.groupby = list(groupby)
        self.aggregates = list(aggregates)

    def _on_execute(self, context) -> Table:
        table = self.input_table(0)
        if not self.groupby and not self.aggregates:
            raise ValueError("Aggregate with no group-by columns and no aggregates")
        sizes = self._dense_sizes(table)
        if sizes is not None:
            out = self._dense(table, sizes)
        else:
            out = self._general(ensure_prefix(table))
        if len(self.groupby) == 1:
            # each group appears once, so a single group-by key is unique in
            # the output (joins against aggregated subqueries take the
            # lookup path, e.g. Q13, Q17, Q18, Q21)
            out.column(self.groupby[0]).unique = True
        for name in self.groupby:
            # group keys are a subset of the input column's values
            out.column(name).val_range = table.column(name).val_range
        return out

    def _compiled(self, table: Table):
        """(out_name, fn, data, validity, input DataType, dictionary) per
        aggregate, its argument evaluated over the whole table; data is None
        for COUNT(*)."""
        compiled = []
        for out_name, agg in self.aggregates:
            if agg.fn is AggregateFunction.COUNT and agg.arg is None:
                compiled.append((out_name, agg.fn, None, None, None, None))
                continue
            ce = compile_expression(agg.arg, table)
            data, validity = ce.fn(make_env(table, ce.required))
            if ce.is_bool:
                data = data.to(torch.int32)
            compiled.append((out_name, agg.fn, data, validity, ce.dtype,
                             ce.dictionary))
        return compiled

    # -- dense cells ------------------------------------------------------------

    def _dense_sizes(self, table: Table) -> Optional[List[int]]:
        """The dictionary sizes of the group-by columns when the dense form
        applies ([] for a global aggregate), else None."""
        if not self.groupby:
            return []
        if any(agg.fn is AggregateFunction.COUNT_DISTINCT
               for _, agg in self.aggregates):
            return None
        sizes, cells = [], 1
        for name in self.groupby:
            c = table.column(name)
            if c.dtype is not DataType.STRING or c.dictionary is None \
                    or c.has_validity:
                return None
            sizes.append(len(c.dictionary))
            cells *= sizes[-1]
        return sizes if 1 <= cells <= DENSE_CELL_MAX else None

    def _dense(self, table: Table, sizes: List[int]) -> Table:
        dev = table.device
        cells = 1
        for s in sizes:
            cells *= s
        cell = torch.zeros(table.capacity, dtype=torch.int32, device=dev)
        for name, size in zip(self.groupby, sizes):
            cell = cell * size + table.column(name).data
        if table.live is not None or table.num_rows < table.capacity:
            cell = torch.where(table.live_mask(), cell, cells)  # dead rows: outside

        rows_per_cell = segment_reduce_cells(None, cell, cells, "count")
        if self.groupby:
            # ascending cell ids are key-sorted group order (codes preserve
            # order), as in the general form; reading them is the host sync
            cell_ids = compact_indices(rows_per_cell > 0)
        else:
            cell_ids = torch.zeros(1, dtype=torch.int64, device=dev)  # always one row

        out_cols: List[Column] = []
        stride = cells
        for name, size in zip(self.groupby, sizes):
            stride //= size
            codes = (cell_ids // stride) % size
            out_cols.append(Column(name, DataType.STRING, codes.to(torch.int32),
                                   None, table.column(name).dictionary))

        def at_groups(per_cell: torch.Tensor) -> torch.Tensor:
            return per_cell.index_select(0, cell_ids)

        # per validity tensor: (the tensor, cells with its NULLs moved outside
        # the cell space like dead rows, valid rows per cell)
        by_validity = {}

        for out_name, fn, data, validity, in_dt, dictionary in self._compiled(table):
            if data is None:  # COUNT(*)
                out_cols.append(Column(out_name, DataType.INT64,
                                       at_groups(rows_per_cell)))
                continue
            data = data.contiguous()
            if validity is None:
                cell_a, counts = cell, rows_per_cell
            else:
                if id(validity) not in by_validity:
                    cell_a = torch.where(validity, cell, cells)
                    by_validity[id(validity)] = (validity, cell_a, segment_reduce_cells(
                        None, cell_a, cells, "count"))
                _, cell_a, counts = by_validity[id(validity)]
            count_g = at_groups(counts)
            nonempty = count_g > 0
            if fn is AggregateFunction.COUNT:
                out_cols.append(Column(out_name, DataType.INT64, count_g))
            elif fn in (AggregateFunction.SUM, AggregateFunction.AVG):
                # float64 sums of float inputs, exact int64 sums of integers
                sums = at_groups(segment_reduce_cells(data, cell_a, cells, "sum"))
                if fn is AggregateFunction.SUM:
                    out_dt = aggregate_result_type(fn, in_dt)
                    out_cols.append(Column(out_name, out_dt,
                                           sums.to(out_dt.torch_dtype), nonempty))
                else:
                    avg = sums.to(torch.float64) / count_g.clamp(min=1).to(torch.float64)
                    out_cols.append(Column(out_name, DataType.FLOAT64, avg, nonempty))
            elif fn in (AggregateFunction.MIN, AggregateFunction.MAX):
                # string codes preserve order: min/max on codes
                is_min = fn is AggregateFunction.MIN
                red = at_groups(segment_reduce_cells(
                    data, cell_a, cells, "min" if is_min else "max",
                    sentinel=_sentinel(data.dtype, is_min)))
                out_cols.append(Column(out_name, in_dt, red, nonempty, dictionary))
            elif fn is AggregateFunction.COUNT_DISTINCT:
                # global only (_dense_sizes): sort the valid values, count runs
                key = _distinct_key(data, in_dt)
                vals = torch.sort(key[cell_a == 0]).values
                distinct = (vals[1:] != vals[:-1]).sum() + min(vals.shape[0], 1)
                out_cols.append(Column(out_name, DataType.INT64,
                                       distinct.reshape(1).to(torch.int64)))
            else:
                raise NotImplementedError(fn)
        return Table(out_cols, cell_ids.shape[0], name=table.name)

    # -- general ----------------------------------------------------------------

    def _general(self, table: Table) -> Table:
        # prefix layout: the live rows are the first num_rows
        n = table.num_rows
        perm = group_permutation(table, self.groupby)
        flags = group_boundaries(table, self.groupby, perm)
        # dead rows sort last: keep the first n of every permuted array
        rows = perm[:n]
        gid = torch.cumsum(flags[:n].to(torch.int64), 0) - 1
        n_groups = int(gid[-1]) + 1 if n else 0
        # group-by key columns: representative = first row of each group
        rep = gather_table(table, rows.index_select(0, compact_indices(flags[:n])))
        out_cols: List[Column] = [rep.column(name) for name in self.groupby]
        for out_name, fn, data, validity, in_dt, dictionary in self._compiled(table):
            out_cols.append(self._compute_aggregate(
                out_name, fn, data, validity, in_dt, dictionary, rows, gid,
                n_groups))
        return Table(out_cols, n_groups, name=table.name)

    @staticmethod
    def _compute_aggregate(out_name: str, fn: AggregateFunction, data, validity,
                           in_dt, dictionary, rows: torch.Tensor,
                           gid: torch.Tensor, n_groups: int) -> Column:
        """One aggregate over the live rows `rows` (in group order), whose
        group ids are `gid`."""
        if data is None:  # COUNT(*)
            counts = torch.bincount(gid, minlength=n_groups)
            return Column(out_name, DataType.INT64, counts)

        d = data.index_select(0, rows)
        v = (torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
             if validity is None else validity.index_select(0, rows))

        out_dt = aggregate_result_type(fn, in_dt)
        counts = segment_sum(v.to(torch.int64), gid, n_groups)
        nonempty = counts > 0

        if fn is AggregateFunction.COUNT:
            return Column(out_name, DataType.INT64, counts)

        if fn is AggregateFunction.COUNT_DISTINCT:
            # re-cluster by (group, validity, value); count the value runs
            # among the valid rows of each group
            key = _distinct_key(d, in_dt)
            perm2 = lexsort([key, (~v).to(torch.int32), gid])
            g2, k2, v2 = (t.index_select(0, perm2) for t in (gid, key, v))
            new_val = v2.clone()
            new_val[1:] &= ((g2[1:] != g2[:-1]) | (k2[1:] != k2[:-1]) | ~v2[:-1])
            return Column(out_name, DataType.INT64,
                          segment_sum(new_val.to(torch.int64), g2, n_groups))

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
            key = d.to(torch.float64 if in_dt.is_floating else torch.int64)
            is_min = fn is AggregateFunction.MIN
            identity = _sentinel(key.dtype, is_min)
            masked = torch.where(v, key, torch.full((), identity, dtype=key.dtype,
                                                    device=key.device))
            reduce = segment_min if is_min else segment_max
            red = reduce(masked, gid, n_groups, identity)
            if in_dt is DataType.STRING:
                return Column(out_name, DataType.STRING, red.to(torch.int32),
                              nonempty, dictionary)
            return Column(out_name, out_dt, red.to(out_dt.torch_dtype), nonempty)

        raise NotImplementedError(fn)

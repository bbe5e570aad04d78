"""Group aggregate operator.

Port of hyrise_tpu/ops/aggregate.py (reference:
src/lib/operators/aggregate.{hpp,cpp}). The input picks one of two forms:

- dense cells: a global aggregate (one cell) or a group-by whose keys are
  all NULL-free dictionary columns spanning at most DENSE_CELL_MAX
  combinations. Each row's cell id is computed from its codes and all
  aggregates are reduced into the cells by one call of the K3 kernel
  (kernels/group_reduce.py segment_reduce_cells_many). A masked-layout
  input is read through its live mask, never compacted. This is the JAX
  package's _fast_scalar and _fast_dense.
- general: any other group-by. Cluster the live rows by the group key with
  one stable multi-key sort, mark boundaries, compact them into the groups'
  start positions; each aggregate is then one reduction over the sorted
  segments (the K7 kernel, kernels/segment_reduce.py).

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
from hyrise_tpu_torch.kernels.prims import (DENSE_CELL_MAX, segment_reduce_cells_many,
                                            segment_reduce_sorted)
from hyrise_tpu_torch.ops.base import AbstractOperator, capacity_mode
from hyrise_tpu_torch.ops.materialize import ensure_prefix, gather_table, mask_to_indices
from hyrise_tpu_torch.ops.sort_util import (group_boundaries, group_permutation,
                                            lexsort)
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import AggregateFunction, DataType, aggregate_result_type


def _distinct_key(data: torch.Tensor, in_dt: DataType) -> torch.Tensor:
    if in_dt.is_integral or in_dt is DataType.STRING:
        return data.to(torch.int64)
    return data.to(torch.float64)


def _distinct_count(key: torch.Tensor, selected: torch.Tensor) -> torch.Tensor:
    """The number of distinct values among key[selected], as a 1-element
    int64 tensor, without a host read: the selected rows first, in key
    order, then count the starts of their runs."""
    order = lexsort([key, (~selected).to(torch.int32)])
    k, sel = key.index_select(0, order), selected.index_select(0, order)
    new = sel.clone()
    new[1:] &= k[1:] != k[:-1]
    return new.sum().reshape(1).to(torch.int64)


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
        if table.has_dead_rows:
            cell = torch.where(table.live_mask(), cell, cells)  # dead rows: outside

        # one K3 launch for the row count, each validity's valid rows and
        # every SUM, AVG, MIN and MAX (a NULL input leaves its aggregate's
        # cells like a dead row)
        compiled = self._compiled(table)
        kinds = {AggregateFunction.COUNT: "count", AggregateFunction.SUM: "sum",
                 AggregateFunction.AVG: "sum", AggregateFunction.MIN: "min",
                 AggregateFunction.MAX: "max"}
        slots = []
        for _, fn, data, validity, _, _ in compiled:
            if data is not None and fn in kinds:
                kind = kinds[fn]
                slots.append((None if kind == "count" else data.contiguous(),
                              None if validity is None else validity.contiguous(), kind))
        rows_per_cell, reduced = segment_reduce_cells_many(cell, cells, slots)
        reduced = iter(reduced)

        if self.groupby:
            # ascending cell ids are key-sorted group order (codes preserve
            # order), as in the general form; reading them is the host sync
            cell_ids, n_groups = mask_to_indices(rows_per_cell > 0, "aggregate.groups")
        else:
            cell_ids = torch.zeros(1, dtype=torch.int64, device=dev)  # always one row
            n_groups = 1

        out_cols: List[Column] = []
        stride = cells
        for name, size in zip(self.groupby, sizes):
            stride //= size
            codes = (cell_ids // stride) % size
            out_cols.append(Column(name, DataType.STRING, codes.to(torch.int32),
                                   None, table.column(name).dictionary))

        def at_groups(per_cell: torch.Tensor) -> torch.Tensor:
            return per_cell.index_select(0, cell_ids)

        for out_name, fn, data, validity, in_dt, dictionary in compiled:
            if data is None:  # COUNT(*)
                out_cols.append(Column(out_name, DataType.INT64,
                                       at_groups(rows_per_cell)))
                continue
            if fn is AggregateFunction.COUNT_DISTINCT:
                # global only (_dense_sizes): sort the valid values, count runs
                cell_a = cell if validity is None else torch.where(validity, cell, cells)
                distinct = _distinct_count(_distinct_key(data, in_dt), cell_a == 0)
                out_cols.append(Column(out_name, DataType.INT64,
                                       distinct.reshape(1).to(torch.int64)))
                continue
            if fn not in kinds:
                raise NotImplementedError(fn)
            result, counts = next(reduced)
            count_g = at_groups(counts)
            nonempty = count_g > 0
            if fn is AggregateFunction.COUNT:
                out_cols.append(Column(out_name, DataType.INT64, count_g))
            elif fn in (AggregateFunction.SUM, AggregateFunction.AVG):
                # float64 sums of float inputs, exact int64 sums of integers
                sums = at_groups(result)
                if fn is AggregateFunction.SUM:
                    out_dt = aggregate_result_type(fn, in_dt)
                    out_cols.append(Column(out_name, out_dt,
                                           sums.to(out_dt.torch_dtype), nonempty))
                else:
                    avg = sums.to(torch.float64) / count_g.clamp(min=1).to(torch.float64)
                    out_cols.append(Column(out_name, DataType.FLOAT64, avg, nonempty))
            else:
                # string codes preserve order: min/max on codes
                out_cols.append(Column(out_name, in_dt, at_groups(result), nonempty,
                                       dictionary))
        return Table(out_cols, n_groups, name=table.name)

    # -- general ----------------------------------------------------------------

    def _general(self, table: Table) -> Table:
        # prefix layout: the live rows are the first num_rows
        n = table.num_rows
        perm = group_permutation(table, self.groupby)
        flags = group_boundaries(table, self.groupby, perm)
        if capacity_mode():
            return self._general_capacity(table, perm, flags)
        # dead rows sort last: keep the first n of every permuted array
        rows = perm[:n]
        # group g is positions [starts[g], starts[g + 1]) of `rows`; reading
        # the number of groups is the host sync
        first, n_groups = mask_to_indices(flags[:n])
        starts = torch.cat([first, torch.full((1,), n, dtype=torch.int64,
                                              device=first.device)])
        # group-by key columns: representative = first row of each group
        rep = gather_table(table, rows.index_select(0, first))
        out_cols: List[Column] = [rep.column(name) for name in self.groupby]
        for out_name, fn, data, validity, in_dt, dictionary in self._compiled(table):
            out_cols.append(self._compute_aggregate(
                out_name, fn, data, validity, in_dt, dictionary, rows, starts,
                flags[:n]))
        return Table(out_cols, n_groups, name=table.name)

    def _general_capacity(self, table: Table, perm: torch.Tensor,
                          flags: torch.Tensor) -> Table:
        """The general form in capacity mode: every sorted position is kept
        (dead rows last, never flagged), the group starts come from the
        oracle's compaction, and the groups past the live count start and end
        at the live row count."""
        dev = table.device
        n = table.num_rows
        if not isinstance(n, torch.Tensor):
            n = torch.full((), n, dtype=torch.int64, device=dev)
        live_sorted = torch.arange(table.capacity, device=dev) < n
        flags = flags & live_sorted
        first, n_groups = mask_to_indices(flags, "aggregate.groups")
        in_use = torch.arange(first.shape[0], device=dev) < n_groups
        starts = torch.cat([torch.where(in_use, first, n), n.reshape(1)])
        rep = gather_table(table, perm.index_select(0, first), num_rows=n_groups)
        out_cols: List[Column] = [rep.column(name) for name in self.groupby]
        for out_name, fn, data, validity, in_dt, dictionary in self._compiled(table):
            if fn is AggregateFunction.COUNT_DISTINCT:
                # dead rows, which the last group's run takes in, count as NULL
                live = table.live_mask()
                validity = live if validity is None else validity & live
            out_cols.append(self._compute_aggregate(
                out_name, fn, data, validity, in_dt, dictionary, perm, starts, flags))
        return Table(out_cols, n_groups, name=table.name)

    @staticmethod
    def _compute_aggregate(out_name: str, fn: AggregateFunction, data, validity,
                           in_dt, dictionary, rows: torch.Tensor,
                           starts: torch.Tensor, flags: torch.Tensor) -> Column:
        """One aggregate over the live rows `rows` (in group order): one
        segmented reduction (the K7 kernel) that gathers through `rows` and
        skips NULL inputs itself. `flags` marks each group's first row."""
        if data is None:  # COUNT(*)
            return Column(out_name, DataType.INT64, starts[1:] - starts[:-1])
        data = data.contiguous()
        validity = None if validity is None else validity.contiguous()
        out_dt = aggregate_result_type(fn, in_dt)

        if fn is AggregateFunction.COUNT:
            counts, _ = segment_reduce_sorted(None, starts, "count", rows, validity)
            return Column(out_name, DataType.INT64, counts)

        if fn is AggregateFunction.COUNT_DISTINCT:
            # re-cluster by (group, validity, value); count the value runs
            # among the valid rows of each group. The group sizes do not
            # change, so `starts` still delimits the groups.
            gid = torch.cumsum(flags.to(torch.int64), 0) - 1
            d = data.index_select(0, rows)
            v = (torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
                 if validity is None else validity.index_select(0, rows))
            key = _distinct_key(d, in_dt)
            perm2 = lexsort([key, (~v).to(torch.int32), gid])
            g2, k2, v2 = (t.index_select(0, perm2) for t in (gid, key, v))
            new_val = v2.clone()
            new_val[1:] &= ((g2[1:] != g2[:-1]) | (k2[1:] != k2[:-1]) | ~v2[:-1])
            distinct, _ = segment_reduce_sorted(new_val.to(torch.int32), starts, "sum")
            return Column(out_name, DataType.INT64, distinct)

        if fn in (AggregateFunction.SUM, AggregateFunction.AVG):
            # float64 sums of float inputs, exact int64 sums of integers
            sums, counts = segment_reduce_sorted(data, starts, "sum", rows, validity)
            nonempty = counts > 0
            if fn is AggregateFunction.SUM:
                return Column(out_name, out_dt, sums.to(out_dt.torch_dtype), nonempty)
            avg = sums.to(torch.float64) / counts.clamp(min=1).to(torch.float64)
            return Column(out_name, DataType.FLOAT64, avg, nonempty)

        if fn in (AggregateFunction.MIN, AggregateFunction.MAX):
            # exact in the input's type; string codes are order-preserving
            red, counts = segment_reduce_sorted(
                data, starts, "min" if fn is AggregateFunction.MIN else "max",
                rows, validity)
            if in_dt is DataType.STRING:
                return Column(out_name, DataType.STRING, red.to(torch.int32),
                              counts > 0, dictionary)
            return Column(out_name, out_dt, red.to(out_dt.torch_dtype), counts > 0)

        raise NotImplementedError(fn)

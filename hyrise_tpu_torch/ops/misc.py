"""Small operators: Limit, Alias, UnionAll, UnionPositions, Difference,
AddRowIds.

Port of hyrise_tpu/ops/misc.py (reference:
src/lib/operators/{limit,alias_operator,union_all,union_positions,
difference}.cpp; AddRowIds is hyrise_tpu/ops/rw_ops.py's, which the SQL
translator also emits for SELECTs when it decorrelates a subquery).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hyrise_tpu_torch.kernels.prims import lookup_last_eq
from hyrise_tpu_torch.ops.base import AbstractOperator, execute_plan
from hyrise_tpu_torch.ops.materialize import (ensure_prefix, filter_table, gather_table,
                                              mask_to_indices)
from hyrise_tpu_torch.storage.column import Column, merge_dictionaries
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, common_numeric_type


class Limit(AbstractOperator):
    """Reference: limit.cpp. Keeps the first n live rows."""

    name = "Limit"

    def __init__(self, input_op: AbstractOperator, n: int):
        super().__init__(input_op)
        self.n = int(n)

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        if isinstance(t.num_rows, torch.Tensor):  # capacity mode
            n = t.num_rows.clamp(max=self.n)
        else:
            n = min(t.num_rows, self.n)
        if t.live is not None:
            # masked layout: keep the first n live rows in the mask
            live = t.live & (torch.cumsum(t.live, 0) <= self.n)
            return Table(t.columns, n, name=t.name, live=live)
        return Table(t.columns, n, name=t.name)


class Alias(AbstractOperator):
    """Reference: alias_operator.cpp. Reorders and renames output columns:
    `names` for all columns in order, or for the columns `sources` picks."""

    name = "Alias"

    def __init__(self, input_op: AbstractOperator, names: Sequence[str],
                 sources: Optional[Sequence[str]] = None):
        super().__init__(input_op)
        self.names = list(names)
        self.sources = list(sources) if sources is not None else None

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        if self.sources is None:
            if len(self.names) != len(t.columns):
                raise ValueError(f"{len(self.names)} names for {len(t.columns)} columns")
            cols = [c.with_name(n) for c, n in zip(t.columns, self.names)]
            # a column whose name an earlier one shadows has no statistics
            renames = [(c.name if t.column(c.name) is c else None, n)
                       for c, n in zip(t.columns, self.names)]
        else:
            cols = [t.column(s).with_name(n)
                    for s, n in zip(self.sources, self.names)]
            renames = list(zip(self.sources, self.names))
        out = Table(cols, t.num_rows, name=t.name, live=t.live)
        out.mvcc = t.mvcc  # same rows in the same positions
        if t.block_stats is not None:
            out.block_stats = t.block_stats.renamed(renames)
        return out


def _align_columns(a: Column, b: Column):
    """Make two columns concatenable: (a, b, dictionary) with a common dtype
    and, for strings, both code sets rewritten into one merged dictionary."""
    from hyrise_tpu_torch.plan.compiler import device_constant

    if (a.dtype is DataType.STRING) != (b.dtype is DataType.STRING):
        raise TypeError("cannot union string with non-string")
    if a.dtype is DataType.STRING:
        if a.dictionary is b.dictionary or np.array_equal(a.dictionary, b.dictionary):
            return a, b, a.dictionary
        merged, ra, rb = merge_dictionaries(a.dictionary, b.dictionary)
        da = device_constant(ra, torch.int64, a.device)[a.data.to(torch.int64)]
        db = device_constant(rb, torch.int64, b.device)[b.data.to(torch.int64)]
        return (Column(a.name, a.dtype, da, a.validity, merged),
                Column(b.name, b.dtype, db, b.validity, merged), merged)
    if a.dtype != b.dtype:
        dt = common_numeric_type(a.dtype, b.dtype)
        a = Column(a.name, dt, a.data.to(dt.torch_dtype), a.validity)
        b = Column(b.name, dt, b.data.to(dt.torch_dtype), b.validity)
    return a, b, None


class UnionAll(AbstractOperator):
    """Reference: union_all.cpp. The left input's rows, then the right's;
    column names come from the left."""

    name = "UnionAll"

    def _on_execute(self, context) -> Table:
        lt = ensure_prefix(self.input_table(0))
        rt = ensure_prefix(self.input_table(1))
        if len(lt.columns) != len(rt.columns):
            raise ValueError("UnionAll inputs differ in column count")
        if isinstance(lt.num_rows, torch.Tensor) or isinstance(rt.num_rows, torch.Tensor):
            return self._capacity_form(lt, rt)
        nl, nr = lt.num_rows, rt.num_rows
        cols: List[Column] = []
        for ca, cb in zip(lt.columns, rt.columns):
            ca, cb, merged = _align_columns(ca, cb)
            data = torch.cat([ca.data[:nl], cb.data[:nr]])
            validity = None
            if ca.validity is not None or cb.validity is not None:
                dev = lt.device
                va = ca.validity[:nl] if ca.validity is not None \
                    else torch.ones(nl, dtype=torch.bool, device=dev)
                vb = cb.validity[:nr] if cb.validity is not None \
                    else torch.ones(nr, dtype=torch.bool, device=dev)
                validity = torch.cat([va, vb])
            cols.append(Column(ca.name, ca.dtype, data, validity,
                               merged if merged is not None else ca.dictionary))
        return Table(cols, nl + nr, name=lt.name)

    @staticmethod
    def _capacity_form(lt: Table, rt: Table) -> Table:
        """Capacity mode: both buffers whole, one after the other, and their
        live rows compacted through the oracle (the JAX package's site)."""
        dev = lt.device
        cols: List[Column] = []
        for ca, cb in zip(lt.columns, rt.columns):
            ca, cb, merged = _align_columns(ca, cb)
            validity = None
            if ca.validity is not None or cb.validity is not None:
                va = ca.validity if ca.validity is not None \
                    else torch.ones(lt.capacity, dtype=torch.bool, device=dev)
                vb = cb.validity if cb.validity is not None \
                    else torch.ones(rt.capacity, dtype=torch.bool, device=dev)
                validity = torch.cat([va, vb])
            cols.append(Column(ca.name, ca.dtype, torch.cat([ca.data, cb.data]), validity,
                               merged if merged is not None else ca.dictionary))
        live = torch.cat([lt.live_mask(), rt.live_mask()])
        indices, n = mask_to_indices(live, "union_all")
        return gather_table(Table(cols, lt.capacity + rt.capacity, name=lt.name),
                            indices, num_rows=n)


class UnionPositions(AbstractOperator):
    """Reference: union_positions.cpp. Set union (duplicates removed) of two
    inputs of one schema: the concatenation, grouped by every column."""

    name = "UnionPositions"

    def _on_execute(self, context) -> Table:
        from hyrise_tpu_torch.ops.aggregate import Aggregate
        from hyrise_tpu_torch.ops.get_table import TableWrapper
        t = execute_plan(UnionAll(self.inputs[0], self.inputs[1]), context)
        return execute_plan(Aggregate(TableWrapper(t), t.column_names, []), context)


class Difference(AbstractOperator):
    """Reference: difference.cpp. The left rows that equal no right row in
    every column (duplicates of the left are kept). Each row is hashed into
    one 64-bit key and the left keys are looked up among the right's."""

    name = "Difference"

    def _on_execute(self, context) -> Table:
        lt, rt = self.input_table(0), self.input_table(1)
        if len(lt.columns) != len(rt.columns):
            raise ValueError("Difference inputs differ in column count")
        # align dictionaries and dtypes pairwise so equal values hash equal
        l_cols, r_cols = [], []
        for ca, cb in zip(lt.columns, rt.columns):
            ca, cb, _ = _align_columns(ca, cb)
            l_cols.append(ca)
            r_cols.append(cb)
        lk = _row_hash(Table(l_cols, lt.num_rows))
        rk = _row_hash(Table(r_cols, rt.num_rows))
        matched, _ = lookup_last_eq(rk, rt.live_mask(), lk)
        return filter_table(lt, ~matched)


def with_row_ids(t: Table) -> Table:
    """`t` with `row_id` appended, each row's position in it: the handle by
    which Delete and Update address the stored table's rows, and by which a
    decorrelated subquery's result is joined back to its outer row."""
    ids = Column("row_id", DataType.INT32,
                 torch.arange(t.capacity, dtype=torch.int32, device=t.device),
                 unique=True, val_range=(0, max(t.capacity - 1, 0)))
    out = Table(list(t.columns) + [ids], t.num_rows, name=t.name, live=t.live)
    out.mvcc = t.mvcc
    return out


class AddRowIds(AbstractOperator):
    """Operator form of with_row_ids."""

    name = "AddRowIds"

    def _on_execute(self, context) -> Table:
        return with_row_ids(self.input_table(0))


_NULL_HASH = 0x9E3779B97F4A7C15 - (1 << 64)  # as a signed 64-bit value
_FNV_PRIME = 1099511628211


def _row_hash(t: Table) -> torch.Tensor:
    """One int64 hash per row over all columns (FNV-style mixing; int64
    products wrap like unsigned 64-bit ones). Equal values hash equal: a
    float contributes its float64 bit pattern with -0.0 folded into 0.0 and
    every NaN into one; a NULL contributes a constant whatever lies under it."""
    h = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    for c in t.columns:
        v = c.data
        if v.is_floating_point():
            f = v.to(torch.float64) + 0.0
            f = torch.where(torch.isnan(f), float("nan"), f)
            v = f.view(torch.int64)
        else:
            v = v.to(torch.int64)
        if c.validity is not None:
            v = torch.where(c.validity, v, _NULL_HASH)
        h = h * _FNV_PRIME + v + 1
    return h

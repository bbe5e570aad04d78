"""Small operators: Limit, Alias, UnionAll.

Port of hyrise_tpu/ops/misc.py (reference:
src/lib/operators/{limit,alias_operator,union_all}.cpp). UnionPositions and
Difference are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix
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
        else:
            cols = [t.column(s).with_name(n)
                    for s, n in zip(self.sources, self.names)]
        return Table(cols, t.num_rows, name=t.name, live=t.live)


def _align_columns(a: Column, b: Column):
    """Make two columns concatenable: (a, b, dictionary) with a common dtype
    and, for strings, both code sets rewritten into one merged dictionary."""
    if (a.dtype is DataType.STRING) != (b.dtype is DataType.STRING):
        raise TypeError("cannot union string with non-string")
    if a.dtype is DataType.STRING:
        if a.dictionary is b.dictionary or np.array_equal(a.dictionary, b.dictionary):
            return a, b, a.dictionary
        merged, ra, rb = merge_dictionaries(a.dictionary, b.dictionary)
        da = torch.as_tensor(ra, device=a.device)[a.data.to(torch.int64)]
        db = torch.as_tensor(rb, device=b.device)[b.data.to(torch.int64)]
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

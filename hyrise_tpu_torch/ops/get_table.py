"""GetTable and TableWrapper.

Port of hyrise_tpu/ops/get_table.py (reference: src/lib/operators/
get_table.{hpp,cpp} and table_wrapper.cpp): fetch a table from a catalog,
or wrap a literal table. Both return the table itself. In capacity mode
(plan/compiler.py) a catalog table must be one the CompiledQuery pinned: a
table replaced under a run raises PlanNotCompilable; and a table of no
positions reads as one dead row, since the capacity forms pad their index
buffers with 0, which must point into the table.
"""

from __future__ import annotations

import torch

from hyrise_tpu_torch.ops.base import AbstractOperator, capacity_mode
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table


def _capacity_source(t: Table) -> Table:
    """`t`, or in capacity mode where `t` has no positions, a table of one
    dead row (zeros) with its columns' names, types and metadata."""
    if t.capacity or not capacity_mode():
        return t
    dev = t.device
    cols = [Column(c.name, c.dtype, torch.zeros(1, dtype=c.data.dtype, device=dev),
                   None if c.validity is None else torch.zeros(1, dtype=torch.bool, device=dev),
                   c.dictionary, unique=c.unique, val_range=c.val_range)
            for c in t.columns]
    return Table(cols, 0, name=t.name)


class GetTable(AbstractOperator):
    name = "GetTable"

    def __init__(self, table_name: str, catalog: Catalog):
        super().__init__()
        self.table_name = table_name
        self.catalog = catalog

    def _on_execute(self, context) -> Table:
        from hyrise_tpu_torch.plan.compiler import PlanNotCompilable, active

        t = self.catalog.get_table(self.table_name)
        ctx = active()
        if ctx is not None and id(t) not in ctx.sources:
            raise PlanNotCompilable(f"table {t.name!r} was not pinned as a source "
                                    f"(the catalog changed under the run)")
        return _capacity_source(t)


class TableWrapper(AbstractOperator):
    name = "TableWrapper"

    def __init__(self, table: Table):
        super().__init__()
        self.table = table

    def _on_execute(self, context) -> Table:
        return _capacity_source(self.table)

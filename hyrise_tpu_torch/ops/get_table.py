"""GetTable and TableWrapper.

Port of hyrise_tpu/ops/get_table.py (reference: src/lib/operators/
get_table.{hpp,cpp} and table_wrapper.cpp): fetch a table from a catalog,
or wrap a literal table. Both return the table itself. In capacity mode
(plan/compiler.py) a catalog table must be one the CompiledQuery pinned: a
table replaced under a run raises PlanNotCompilable.
"""

from __future__ import annotations

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.storage.catalog import Catalog
from hyrise_tpu_torch.storage.table import Table


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
        return t


class TableWrapper(AbstractOperator):
    name = "TableWrapper"

    def __init__(self, table: Table):
        super().__init__()
        self.table = table

    def _on_execute(self, context) -> Table:
        return self.table

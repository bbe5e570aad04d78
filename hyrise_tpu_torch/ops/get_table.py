"""GetTable and TableWrapper.

Port of hyrise_tpu/ops/get_table.py (reference: src/lib/operators/
get_table.{hpp,cpp} and table_wrapper.cpp): fetch a table from a catalog,
or wrap a literal table. The port runs eagerly, so both return the table
itself.
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
        return self.catalog.get_table(self.table_name)


class TableWrapper(AbstractOperator):
    name = "TableWrapper"

    def __init__(self, table: Table):
        super().__init__()
        self.table = table

    def _on_execute(self, context) -> Table:
        return self.table

"""Catalog — the StorageManager equivalent.

Port of hyrise_tpu/storage/catalog.py (reference:
src/lib/storage/storage_manager.hpp:19-66): a name→Table map plus LQP
views. Callers create a Catalog and pass it to the operators that read it;
there is no process-wide default instance.
"""

from __future__ import annotations

from typing import Dict, List

from hyrise_tpu_torch.storage.table import Table


class Catalog:
    def __init__(self) -> None:
        self._tables: Dict[str, Table] = {}
        self._views: Dict[str, object] = {}  # name -> LQP

    # Tables
    def add_table(self, name: str, table: Table) -> None:
        if name in self._tables or name in self._views:
            raise ValueError(f"table or view {name!r} already exists")
        table.name = name
        self._tables[name] = table

    def drop_table(self, name: str) -> None:
        if name not in self._tables:
            raise KeyError(f"no such table {name!r}")
        del self._tables[name]

    def get_table(self, name: str) -> Table:
        if name not in self._tables:
            raise KeyError(f"no such table {name!r}")
        return self._tables[name]

    def has_table(self, name: str) -> bool:
        return name in self._tables

    def table_names(self) -> List[str]:
        return sorted(self._tables)

    def replace_table(self, name: str, table: Table) -> None:
        table.name = name
        self._tables[name] = table

    # Views (reference: StorageManager::add_lqp_view)
    def add_view(self, name: str, lqp) -> None:
        if name in self._tables or name in self._views:
            raise ValueError(f"table or view {name!r} already exists")
        self._views[name] = lqp

    def drop_view(self, name: str) -> None:
        del self._views[name]

    def get_view(self, name: str):
        return self._views[name]

    def has_view(self, name: str) -> bool:
        return name in self._views

    def view_names(self) -> List[str]:
        return sorted(self._views)

    def reset(self) -> None:
        self._tables.clear()
        self._views.clear()

"""Catalog — the StorageManager equivalent.

Port of hyrise_tpu/storage/catalog.py (reference:
src/lib/storage/storage_manager.hpp:19-66): a name→Table map plus LQP
views. Callers create a Catalog and pass it to the operators that read it;
there is no process-wide default instance. Each catalog owns the
TransactionManager of its tables' transactions (the reference keeps one
beside its StorageManager).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from hyrise_tpu_torch.concurrency.transaction import TransactionManager
from hyrise_tpu_torch.storage.table import Table


class Catalog:
    def __init__(self, device=None) -> None:
        self._tables: Dict[str, Table] = {}
        self._views: Dict[str, object] = {}  # name -> LQP
        self._device = None if device is None else torch.device(device)
        self._transaction_manager = TransactionManager()
        # counts writes: tables added, replaced or dropped, rows inserted or
        # deleted (the plan cache re-resolves scalar subqueries after one)
        self.version = 0
        # CompiledQuerys (plan/compiler.py) over this catalog's tables, kept
        # by their makers (tpch/queries.py, sql/pipeline.py) for the next
        # caller; they go with the catalog, captured graphs and all
        self.compiled: Dict[object, object] = {}

    def mark_changed(self) -> None:
        self.version += 1

    # Tables
    def add_table(self, name: str, table: Table) -> None:
        if name in self._tables or name in self._views:
            raise ValueError(f"table or view {name!r} already exists")
        table.name = name
        self._tables[name] = table
        self.mark_changed()

    def drop_table(self, name: str) -> None:
        if name not in self._tables:
            raise KeyError(f"no such table {name!r}")
        del self._tables[name]
        self.mark_changed()

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
        self.mark_changed()

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

    @property
    def device(self) -> torch.device:
        """Where the SQL path puts the tables it makes itself (CREATE TABLE,
        SHOW, EXPLAIN, SELECT without FROM): the device the catalog was
        created with, else the one its tables live on, else the card."""
        if self._device is not None:
            return self._device
        for t in self._tables.values():
            return t.device
        return torch.device("cuda")

    @property
    def transaction_manager(self) -> TransactionManager:
        """The TransactionManager of this catalog's tables (made with the
        catalog, so that concurrent sessions share one)."""
        return self._transaction_manager

    def table_statistics(self, name: str):
        """TableStatistics of a table, generated on first use and cached on
        the table until its row count changes (the optimizer's predicate
        reordering and join ordering read them)."""
        t = self.get_table(name)
        stats = getattr(t, "_stats_cache", None)
        if stats is None or getattr(t, "_stats_rows", -1) != t.num_rows:
            from hyrise_tpu_torch.plan.statistics import generate_table_statistics
            stats = generate_table_statistics(t)
            t._stats_cache = stats
            t._stats_rows = t.num_rows
        return stats

    def all_statistics(self):
        return {name: self.table_statistics(name) for name in self._tables}

    def reset(self) -> None:
        self._tables.clear()
        self._views.clear()
        self.mark_changed()

"""Tables.

Port of hyrise_tpu/storage/table.py: a named set of equally long columns on
one device plus a host-known live row count. A base table's capacity equals
its row count.

Row layouts: by default rows [0, num_rows) are live (PREFIX layout). A table
may instead carry an explicit `live` bool mask (MASKED layout); operators
read live_mask() either way, and ops/materialize.ensure_prefix compacts a
masked table where an operator needs a prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.types import DataType


@dataclasses.dataclass
class TableColumnDefinition:
    """Reference: TableColumnDefinition in src/lib/storage/table_column_definition.hpp."""

    name: str
    dtype: DataType
    nullable: bool = False


class Table:
    """A named collection of equally-sized columns plus a live row count."""

    def __init__(self, columns: Sequence[Column], num_rows: int, name: str = "",
                 live: Optional[torch.Tensor] = None):
        assert len(columns) > 0
        caps = {c.capacity for c in columns}
        assert len(caps) == 1, f"column capacities differ: {caps}"
        devices = {c.device for c in columns}
        assert len(devices) == 1, f"columns on several devices: {devices}"
        self.columns: List[Column] = list(columns)
        self.num_rows = int(num_rows)
        self.live = live  # None = prefix layout
        self.name = name
        # Duplicate names can occur after joins (both sides kept, like the
        # reference); lookup resolves to the FIRST occurrence.
        self._by_name: Dict[str, int] = {}
        for i, c in enumerate(columns):
            self._by_name.setdefault(c.name, i)

    @staticmethod
    def from_arrays(name: str, defs: Sequence[TableColumnDefinition],
                    arrays: Sequence[np.ndarray],
                    validities: Optional[Sequence[Optional[np.ndarray]]] = None,
                    *, device) -> "Table":
        n = len(arrays[0])
        cols = []
        for i, (d, arr) in enumerate(zip(defs, arrays)):
            v = validities[i] if validities is not None else None
            cols.append(Column.from_numpy(d.name, d.dtype, arr, validity=v,
                                          device=device))
        return Table(cols, n, name=name)

    # -- accessors -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> Column:
        if name not in self._by_name:
            raise KeyError(f"table {self.name!r} has no column {name!r}; "
                           f"has {self.column_names}")
        return self.columns[self._by_name[name]]

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    @property
    def is_prefix(self) -> bool:
        return self.live is None

    def live_mask(self) -> torch.Tensor:
        """Bool (capacity,): the live rows (mask layout) or rows < num_rows
        (prefix layout)."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, device=self.device) < self.num_rows

    # -- conversion ----------------------------------------------------------

    def _decode_col(self, c: Column) -> np.ndarray:
        if self.live is None:
            return c.decode(self.num_rows)
        m = self.live.cpu().numpy()
        return c.decode(self.capacity)[m]

    def to_pandas(self):
        import pandas as pd

        data = {}
        for c in self.columns:
            # Keep duplicate output names distinct for pandas.
            k = c.name
            suffix = 1
            while k in data:
                k = f"{c.name}.{suffix}"
                suffix += 1
            data[k] = self._decode_col(c)
        return pd.DataFrame(data)

    def rows(self) -> List[tuple]:
        """All live rows as python tuples (tests / printing)."""
        decoded = [self._decode_col(c) for c in self.columns]
        n = len(decoded[0])
        return [tuple(col[i] for col in decoded) for i in range(n)]

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.value}" for c in self.columns)
        return (f"Table({self.name!r}, rows={self.num_rows}, "
                f"cap={self.capacity}, device={self.device}, [{cols}])")

"""Tables.

Port of hyrise_tpu/storage/table.py: a named set of equally long columns on
one device plus a host-known live row count. A base table's capacity is its
row count, except for a table that rows were inserted into
(ops/rw_ops.py): it keeps headroom past `num_rows` for the next inserts.

Row layouts: by default rows [0, num_rows) are live (PREFIX layout). A table
may instead carry an explicit `live` bool mask (MASKED layout); operators
read live_mask() either way, and ops/materialize.ensure_prefix compacts a
masked table where an operator needs a prefix.

In capacity mode (plan/compiler.py) a variable-size output is a buffer of
capacity rows whose `num_rows` is a 0-dim int64 tensor on the device;
live_mask() compares positions with it there, and rows() / to_pandas read
it once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.types import DataType
from hyrise_tpu_torch.utils import spans


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
        # a host int, or in capacity mode a 0-dim int64 tensor on the device
        self.num_rows = num_rows if isinstance(num_rows, torch.Tensor) else int(num_rows)
        self.live = live  # None = prefix layout
        self.name = name
        self.mvcc = None  # concurrency.transaction.MvccData of an MVCC table
        # physical design of a stored table (storage/encoding.py,
        # block_statistics.py, index.py). A table derived from this one
        # starts without them: statistics and indexes would be stale, and
        # only ChunkEncoder and Insert carry the encoding spec on. Alias and
        # a forwarding Projection keep every row in its place and carry the
        # statistics on.
        self.encoding_spec = None
        self.block_stats = None
        self.indexes: Dict[object, object] = {}
        # the span id of the statement that returned this table as its
        # result while spans were recorded (utils/spans.py), which the
        # spans of its decode carry
        self.statement: Optional[int] = None
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

    @property
    def has_dead_rows(self) -> bool:
        """Whether some position of the capacity may hold no live row, known
        without reading the device."""
        return (self.live is not None or isinstance(self.num_rows, torch.Tensor)
                or self.num_rows < self.capacity)

    def live_mask(self) -> torch.Tensor:
        """Bool (capacity,): the live rows (mask layout) or rows < num_rows
        (prefix layout)."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, device=self.device) < self.num_rows

    def block(self, lo: int, hi: int) -> "Table":
        """Rows [lo, hi) of this table as a table over the same storage
        (Column.block), for streamed execution (plan/blocked.py). The live
        mask and the MVCC vectors are sliced too, so a Validate over the
        block sees what it would see of these rows in the whole table; the
        encoding spec carries over. Block statistics and indexes describe
        the whole table's positions and are dropped. A masked table's block
        counts its live rows with one host read."""
        assert 0 <= lo <= hi <= self.capacity, (lo, hi, self.capacity)
        live = None if self.live is None else self.live[lo:hi]
        n = max(min(hi, self.num_rows) - lo, 0) if live is None else int(live.sum())
        out = Table([c.block(lo, hi) for c in self.columns], n, name=self.name, live=live)
        if self.mvcc is not None:
            m = self.mvcc  # the same write lock: the vectors are the table's
            out.mvcc = dataclasses.replace(m, tids=m.tids[lo:hi],
                                           begin_cids=m.begin_cids[lo:hi],
                                           end_cids=m.end_cids[lo:hi])
        out.encoding_spec = self.encoding_spec
        return out

    # -- conversion ----------------------------------------------------------

    def _decode_col(self, c: Column) -> np.ndarray:
        if self.live is None:
            return c.decode(int(self.num_rows))
        m = self.live.cpu().numpy()
        return c.decode(self.capacity)[m]

    def _live_rows(self):
        """(rows to copy, the live mask over them or None), with the row
        count or the live mask read once from the device."""
        if self.live is None:
            n = self.num_rows
            if isinstance(n, torch.Tensor):
                with spans.span("decode.copy"):
                    n = int(n)  # one read of a device count
            return n, None
        with spans.span("decode.copy") as span:
            m = self.live.cpu().numpy()
            span.set("bytes", m.nbytes)
        return self.capacity, m

    def _decoded(self) -> List[np.ndarray]:
        """Every column's live rows on the host (Column.decode)."""
        n, m = self._live_rows()
        if m is None:
            return [c.decode(n) for c in self.columns]
        return [c.decode(n)[m] for c in self.columns]

    def to_pandas(self):
        """The live rows as a DataFrame, each column as
        Column.decode_frame_column gives it. Spans: `decode`, with the
        copies, the strings and `decode.frame` (the DataFrame's build) in
        it."""
        import pandas as pd

        with spans.span("decode", self.statement):
            n, m = self._live_rows()
            data = {}
            for c in self.columns:
                # Keep duplicate output names distinct for pandas.
                k = c.name
                suffix = 1
                while k in data:
                    k = f"{c.name}.{suffix}"
                    suffix += 1
                data[k] = c.decode_frame_column(n, m)
            with spans.span("decode.frame", cpu=True):
                return pd.DataFrame(data)

    def rows(self) -> List[tuple]:
        """All live rows as python tuples (tests / printing)."""
        with spans.span("decode", self.statement):
            decoded = self._decoded()
            n = len(decoded[0])
            return [tuple(col[i] for col in decoded) for i in range(n)]

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.dtype.value}" for c in self.columns)
        return (f"Table({self.name!r}, rows={self.num_rows}, "
                f"cap={self.capacity}, device={self.device}, [{cols}])")

"""Column indexes.

Port of hyrise_tpu/storage/index.py (reference: src/lib/storage/index/:
GroupKeyIndex, CompositeGroupKeyIndex, AdaptiveRadixTree and BTree behind
base_index.hpp, consumed by IndexScan and JoinIndex).

One shape serves every role: the sorted permutation of a column. `perm`
holds the table's valid rows (live and not NULL) in ascending (value, row)
order, and `sorted_values` their values in that order, so a lookup is a
binary search that gives a contiguous range of `perm`. The order is the one
kernels/prims.sort_valid_keys gives, which the sorted join uses too, so
JoinIndex (ops/join.py) takes an index in place of its own sort. NULL and
dead rows are not in `perm` at all; NaN values sort last, behind
`n_ordered`, and no comparison's range reaches them.

- SortedIndex: any column. A lookup is one host read.
- GroupKeyIndex: a string column. Its codes are dense in [0, dictionary
  size), so host `offsets` give each code's range with no device read.
- CompositeSortedIndex: several columns in lexicographic order; an
  equality lookup on a prefix of them narrows the range level by level,
  one host read a level.

An index belongs to the Table object it was built on (`table.indexes`);
a table derived from it (a filter, a compaction, an append) has none.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hyrise_tpu_torch.kernels.prims import compact_indices, sort_valid_keys
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType


def _valid_rows(table: Table, columns) -> torch.Tensor:
    valid = table.live_mask()
    for c in columns:
        if c.validity is not None:
            valid = valid & c.validity
    return valid


@dataclasses.dataclass
class SortedIndex:
    column: str
    perm: torch.Tensor           # int64 rows, (value, row) order
    sorted_values: torch.Tensor  # the column's values in that order
    n_valid: int                 # rows in perm: live and not NULL
    n_ordered: int               # of them, rows with a value other than NaN

    def lookup(self, value) -> Tuple[int, int]:
        """(the first position of perm whose value is >= `value`, the first
        whose value is > `value`) among the rows that have an order; one
        host read. `value` must be of the column's type."""
        values = self.sorted_values[:self.n_ordered]
        key = torch.tensor(value, dtype=values.dtype, device=values.device)
        start, end = torch.stack([torch.searchsorted(values, key),
                                  torch.searchsorted(values, key, right=True)]).tolist()
        return start, end


@dataclasses.dataclass
class GroupKeyIndex(SortedIndex):
    """A string column's index (reference group_key_index.hpp): code v's
    rows are perm[offsets[v]:offsets[v + 1]], found on the host."""

    offsets: np.ndarray = None  # int64, dictionary size + 1; [-1] == n_valid

    def lookup(self, value) -> Tuple[int, int]:
        last = len(self.offsets) - 1
        code = int(value)
        return (int(self.offsets[min(max(code, 0), last)]),
                int(self.offsets[min(max(code + 1, 0), last)]))


def create_index(table: Table, column: Union[str, Sequence[str]]):
    """Build an index on `column` (a name, or several for a composite
    index) and keep it on the table."""
    if not isinstance(column, str):
        columns = tuple(column)
        if len(columns) > 1:
            return create_composite_index(table, columns)
        column = columns[0]
    c = table.column(column)
    sorted_values, perm = sort_valid_keys(c.data, _valid_rows(table, [c]))
    n_valid = perm.shape[0]
    n_ordered = n_valid
    if sorted_values.is_floating_point():  # NaNs sort last
        n_ordered -= int(sorted_values.isnan().sum())
    if c.dtype is DataType.STRING:
        codes = torch.arange(len(c.dictionary) + 1, dtype=sorted_values.dtype,
                             device=sorted_values.device)
        offsets = torch.searchsorted(sorted_values, codes).cpu().numpy().astype(np.int64)
        idx: SortedIndex = GroupKeyIndex(column, perm, sorted_values, n_valid, n_ordered,
                                         offsets)
    else:
        idx = SortedIndex(column, perm, sorted_values, n_valid, n_ordered)
    table.indexes = {**table.indexes, column: idx}
    return idx


@dataclasses.dataclass
class CompositeSortedIndex:
    """Rows in lexicographic order of several columns (reference
    composite_group_key_index.hpp); the levels stay separate tensors."""

    columns: Tuple[str, ...]
    perm: torch.Tensor                 # int64 rows with every level valid
    sorted_values: List[torch.Tensor]  # per level, in perm order
    n_valid: int

    def lookup_equals(self, values: Sequence) -> Tuple[int, int]:
        """[start, end) of the rows equal to a prefix of the key, each value
        of its level's type; one host read a level."""
        if len(values) > len(self.columns):
            raise ValueError(f"{len(values)} values for {len(self.columns)} columns")
        start, end = 0, self.n_valid
        for level, v in zip(self.sorted_values, values):
            segment = level[start:end]
            key = torch.tensor(v, dtype=segment.dtype, device=segment.device)
            lo, hi = torch.stack([torch.searchsorted(segment, key),
                                  torch.searchsorted(segment, key, right=True)]).tolist()
            start, end = start + lo, start + hi
            if start >= end:
                return start, start
        return start, end


def create_composite_index(table: Table, columns: Sequence[str]) -> CompositeSortedIndex:
    cols = [table.column(name) for name in columns]
    perm = compact_indices(_valid_rows(table, cols))
    for c in reversed(cols):  # least significant level first, stable
        order = torch.sort(c.data.index_select(0, perm), stable=True).indices
        perm = perm.index_select(0, order)
    idx = CompositeSortedIndex(tuple(columns), perm,
                               [c.data.index_select(0, perm) for c in cols],
                               perm.shape[0])
    table.indexes = {**table.indexes, tuple(columns): idx}
    return idx


def get_index(table: Table, column: Union[str, Sequence[str]]):
    return table.indexes.get(column if isinstance(column, str) else tuple(column))


def find_composite_index(table: Table, columns: Sequence[str]
                         ) -> Optional[CompositeSortedIndex]:
    """A composite index whose columns start with `columns`: it serves an
    equality lookup on that prefix."""
    want = tuple(columns)
    for key, idx in table.indexes.items():
        if isinstance(key, tuple) and key[:len(want)] == want:
            return idx
    return None

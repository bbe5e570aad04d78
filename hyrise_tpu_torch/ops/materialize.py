"""Selection materialization — the PosList / ReferenceColumn equivalent.

Port of hyrise_tpu/ops/materialize.py (reference:
src/lib/storage/reference_column.hpp:19-51 and PosList, types.hpp:138). A
selection is a dense int64 index tensor whose length is the row count:
counting its rows is one device->host sync per variable-size operator,
matching the reference's per-operator barrier. There is no capacity
padding and no capacity oracle: the count is read eagerly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from hyrise_tpu_torch.kernels.prims import compact_indices
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table


def mask_to_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Compact a bool mask into (indices of its True rows, their count)."""
    indices = compact_indices(mask)
    return indices, indices.shape[0]


def gather_columns_at(table: Table, indices: torch.Tensor,
                      extra_valid: Optional[torch.Tensor] = None,
                      preserve_unique: bool = False) -> List[Column]:
    """Columns of table[indices], each gathered lazily on first read (late
    materialization: only columns read downstream pay their gather).

    `extra_valid` (bool, aligned with `indices`) marks the rows that keep
    their values; the others become NULL (an outer join's padding).
    `preserve_unique` is set only when `indices` are pairwise distinct (a
    filter compaction or a permutation), so `unique` flags survive. A
    gather takes a subset of the source's values, so `val_range` always
    survives."""
    cap = indices.shape[0]
    if table.capacity == 0 and cap:
        # nothing to gather from: only dead or NULL-padded rows can point
        # into an empty table, so every value is NULL
        null = torch.zeros(cap, dtype=torch.bool, device=table.device)
        return [Column(c.name, c.dtype,
                       torch.zeros(cap, dtype=c.dtype.torch_dtype, device=table.device),
                       null, c.dictionary, val_range=c.val_range)
                for c in table.columns]
    cols = []
    for c in table.columns:
        data = lambda col=c: col.data.index_select(0, indices)  # noqa: E731
        if not c.has_validity:
            validity = extra_valid
        elif extra_valid is None:
            validity = lambda col=c: col.validity.index_select(0, indices)  # noqa: E731
        else:
            validity = lambda col=c: (  # noqa: E731
                col.validity.index_select(0, indices) & extra_valid)
        cols.append(Column(c.name, c.dtype, data, validity, c.dictionary,
                           device=table.device, capacity=cap,
                           unique=c.unique and preserve_unique,
                           val_range=c.val_range))
    return cols


def gather_table(table: Table, indices: torch.Tensor,
                 preserve_unique: bool = False) -> Table:
    """table[indices] as a new prefix-layout table (see gather_columns_at)."""
    return Table(gather_columns_at(table, indices,
                                   preserve_unique=preserve_unique),
                 indices.shape[0], name=table.name)


def filter_table(table: Table, mask: torch.Tensor) -> Table:
    """Rows of `table` where `mask` (capacity,) holds, ANDed with the live
    rows, compacted into a prefix-layout table with lazy columns."""
    indices, _ = mask_to_indices(mask & table.live_mask())
    return gather_table(table, indices, preserve_unique=True)


def ensure_prefix(table: Table) -> Table:
    """A masked-layout table's live rows as a prefix-layout table (lazy
    gathers, so only the columns read downstream move). No-op for prefix
    tables. The JAX package's compact_if_shrunk compacts only when the live
    count's capacity bucket shrank; without buckets that is any masked
    table, so the two are one function here."""
    if table.live is None:
        return table
    return gather_table(table, compact_indices(table.live), preserve_unique=True)

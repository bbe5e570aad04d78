"""Selection materialization — the PosList / ReferenceColumn equivalent.

Port of hyrise_tpu/ops/materialize.py (reference:
src/lib/storage/reference_column.hpp:19-51 and PosList, types.hpp:138). A
selection is a dense int64 index tensor whose length is the row count:
counting its rows is one device->host sync per variable-size operator,
matching the reference's per-operator barrier. There is no capacity
padding and no capacity oracle: the count is read eagerly.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hyrise_tpu_torch.kernels.prims import compact_indices
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table


def mask_to_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Compact a bool mask into (indices of its True rows, their count)."""
    indices = compact_indices(mask)
    return indices, indices.shape[0]


def gather_columns_at(table: Table, indices: torch.Tensor) -> List[Column]:
    """Columns of table[indices], each gathered lazily on first read (late
    materialization: only columns read downstream pay their gather)."""
    cap = indices.shape[0]
    cols = []
    for c in table.columns:
        data = lambda col=c: col.data.index_select(0, indices)  # noqa: E731
        validity = None
        if c.has_validity:
            validity = lambda col=c: col.validity.index_select(0, indices)  # noqa: E731
        cols.append(Column(c.name, c.dtype, data, validity, c.dictionary,
                           device=table.device, capacity=cap))
    return cols


def gather_table(table: Table, indices: torch.Tensor) -> Table:
    """table[indices] as a new prefix-layout table (see gather_columns_at)."""
    return Table(gather_columns_at(table, indices), indices.shape[0],
                 name=table.name)


def filter_table(table: Table, mask: torch.Tensor) -> Table:
    """Rows of `table` where `mask` (capacity,) holds, ANDed with the live
    rows, compacted into a prefix-layout table with lazy columns."""
    indices, _ = mask_to_indices(mask & table.live_mask())
    return gather_table(table, indices)


def ensure_prefix(table: Table) -> Table:
    """A masked-layout table's live rows as a prefix-layout table (lazy
    gathers, so only the columns read downstream move). No-op for prefix
    tables. The JAX package's compact_if_shrunk compacts only when the live
    count's capacity bucket shrank; without buckets that is any masked
    table, so the two are one function here."""
    if table.live is None:
        return table
    return gather_table(table, compact_indices(table.live))

"""Build a port Table from plain host arrays.

This is how state crosses from another engine (the JAX package, in the
parity tests) into the port without the port importing it: the caller
exports each column as numpy arrays, and the port uploads exactly those
bytes, padding rows and live mask included.
"""

from __future__ import annotations

from typing import Collection, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

# (name, DataType value such as "int32", data, validity or None,
#  dictionary or None)
ColumnExport = Tuple[str, str, np.ndarray, Optional[np.ndarray],
                     Optional[np.ndarray]]


def table_from_numpy(name: str, columns: Sequence[ColumnExport], num_rows: int,
                     live: Optional[np.ndarray] = None, *, device,
                     unique: Collection[str] = (),
                     val_ranges: Optional[Mapping[str, Optional[Tuple[int, int]]]] = None
                     ) -> Table:
    """A Table over `columns` on `device`. Every data array has the same
    length (the capacity); rows past `num_rows` are dead unless `live`
    (a bool array of that length) names the live rows instead.

    `unique` names the columns whose live values the exporter knows to be
    pairwise distinct. `val_ranges` carries the exporter's (min, max) per
    integer column, None for a column without one; when it is not given,
    each integer column's range is taken over its whole array, dead rows
    included (wider, and still a valid bound)."""
    cols = []
    for col_name, dtype_value, data, validity, dictionary in columns:
        dtype = DataType(dtype_value)
        if dtype is DataType.STRING and dictionary is None:
            raise ValueError(f"STRING column {col_name!r} needs its dictionary")
        col = Column.from_numpy(col_name, dtype, data, validity, dictionary,
                                device=device)
        col.unique = col_name in unique
        if val_ranges is not None:
            col.val_range = val_ranges.get(col_name)
        cols.append(col)
    live_t = None
    if live is not None:
        live_t = torch.tensor(np.asarray(live, dtype=bool), device=device)
    return Table(cols, num_rows, name=name, live=live_t)

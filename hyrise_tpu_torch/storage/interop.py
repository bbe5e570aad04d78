"""Build a port Table from plain host arrays.

This is how state crosses from another engine (the JAX package, in the
parity tests) into the port without the port importing it: the caller
exports each column as numpy arrays, and the port uploads exactly those
bytes, padding rows and live mask included. An encoded column may cross as
its at-rest payload instead of its dense values (storage/encoding.py).
"""

from __future__ import annotations

from typing import Collection, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.concurrency.transaction import MvccData
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.encoding import (EncodingType, FrameOfReferenceColumn,
                                               NarrowCodes, RunLengthColumn)
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType

# (name, DataType value such as "int32", data, validity or None,
#  dictionary or None)
ColumnExport = Tuple[str, str, np.ndarray, Optional[np.ndarray],
                     Optional[np.ndarray]]
# an encoded column's at-rest payload, as (EncodingType value, two arrays,
# row count): ("dictionary", codes, numeric dictionary or None, n),
# ("run_length", values, end positions, n) or ("frame_of_reference",
# frames, offsets, n)
EncodedExport = Tuple[str, np.ndarray, Optional[np.ndarray], int]


def _payload(export: EncodedExport, device):
    kind, a, b, n = export
    up = lambda x: None if x is None else torch.tensor(x, device=device)  # noqa: E731
    if kind == EncodingType.DICTIONARY.value:
        return NarrowCodes(up(a), up(b))
    if kind == EncodingType.RUN_LENGTH.value:
        return RunLengthColumn(up(a), up(b), n)
    if kind == EncodingType.FRAME_OF_REFERENCE.value:
        return FrameOfReferenceColumn(up(a), up(b), n)
    raise ValueError(f"unknown encoding {kind!r}")


def table_from_numpy(name: str, columns: Sequence[ColumnExport], num_rows: int,
                     live: Optional[np.ndarray] = None, *, device,
                     unique: Collection[str] = (),
                     val_ranges: Optional[Mapping[str, Optional[Tuple[int, int]]]] = None,
                     mvcc: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                     encoded: Optional[Mapping[str, EncodedExport]] = None
                     ) -> Table:
    """A Table over `columns` on `device`. Every data array has the same
    length (the capacity); rows past `num_rows` are dead unless `live`
    (a bool array of that length) names the live rows instead.

    `unique` names the columns whose live values the exporter knows to be
    pairwise distinct. `val_ranges` carries the exporter's (min, max) per
    integer column, None for a column without one; when it is not given,
    each integer column's range is taken over its whole array, dead rows
    included (wider, and still a valid bound).

    `mvcc` is the exporter's MVCC state as (tids, begin cids, end cids),
    int64 arrays at least as long as the capacity: it becomes the table's
    MvccData on `device`, cut to the capacity.

    `encoded` maps a column's name to its exported payload: the column is
    then that payload on `device`, decoded on first read, and its `data`
    entry is not read (it may be None). Its range, when `val_ranges` does
    not give it, is taken over the decoded values."""
    cols = []
    encoded = encoded or {}
    for col_name, dtype_value, data, validity, dictionary in columns:
        dtype = DataType(dtype_value)
        if dtype is DataType.STRING and dictionary is None:
            raise ValueError(f"STRING column {col_name!r} needs its dictionary")
        if col_name in encoded:
            payload = _payload(encoded[col_name], device)
            vmask = None if validity is None else \
                torch.tensor(np.asarray(validity, dtype=bool), device=device)
            dense = payload.decode(dtype.torch_dtype)
            col = Column(col_name, dtype, lambda p=payload, dt=dtype.torch_dtype: p.decode(dt),
                         vmask, dictionary, device, dense.shape[0], encoded=payload)
            if dtype.is_integral and dense.shape[0]:
                col.val_range = tuple(torch.stack([dense.amin(), dense.amax()]).tolist())
        else:
            col = Column.from_numpy(col_name, dtype, data, validity, dictionary,
                                    device=device)
        col.unique = col_name in unique
        if val_ranges is not None:
            col.val_range = val_ranges.get(col_name)
        cols.append(col)
    live_t = None
    if live is not None:
        live_t = torch.tensor(np.asarray(live, dtype=bool), device=device)
    table = Table(cols, num_rows, name=name, live=live_t)
    if mvcc is not None:
        cap = table.capacity
        tids, begin, end = (torch.tensor(np.asarray(a, dtype=np.int64)[:cap], device=device)
                            for a in mvcc)
        table.mvcc = MvccData(tids, begin, end)
    return table

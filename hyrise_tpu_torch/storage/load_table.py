""".tbl table loader.

Port of hyrise_tpu/storage/load_table.py (reference:
src/lib/utils/load_table.cpp): pipe-separated text with a header of column
names, a second line of types (`int|long|float|double|string`, a `_null`
suffix marks a nullable column) and the literal `null` for a NULL value.
The rows are parsed on the host and uploaded to the device the caller
names, the card unless it asks for another.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType

TYPE_NAMES = {
    "int": DataType.INT32,
    "long": DataType.INT64,
    "float": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "string": DataType.STRING,
}


def load_table(path: str, name: str = "", *, device="cuda") -> Table:
    with open(path, "r") as f:
        lines = [ln.rstrip("\n") for ln in f]
    lines = [ln for ln in lines if ln != ""]
    names = lines[0].split("|")
    type_specs = lines[1].split("|")

    defs: List[TableColumnDefinition] = []
    for col_name, spec in zip(names, type_specs):
        parts = spec.split("_")
        base = parts[0]
        nullable = len(parts) > 1 and parts[1] == "null"
        if base not in TYPE_NAMES:
            raise ValueError(f"invalid data type {base!r} for column {col_name!r}")
        defs.append(TableColumnDefinition(col_name, TYPE_NAMES[base], nullable))

    n_cols = len(defs)
    raw: List[List[Optional[str]]] = [[] for _ in range(n_cols)]
    for ln in lines[2:]:
        cells = ln.split("|")
        if len(cells) != n_cols:
            raise ValueError(f"bad row in {path}: {ln!r}")
        for i, cell in enumerate(cells):
            raw[i].append(None if defs[i].nullable and cell == "null" else cell)

    arrays, validities = [], []
    for d, col in zip(defs, raw):
        null_mask = np.array([v is None for v in col], dtype=bool)
        if d.dtype is DataType.STRING:
            arrays.append(np.array(col, dtype=object))
        else:
            parse = int if d.dtype.is_integral else float
            arrays.append(np.array([parse("0" if v is None else v) for v in col],
                                   dtype=d.dtype.numpy_dtype))
        validities.append(~null_mask if d.nullable else None)

    return Table.from_arrays(name or path, defs, arrays, validities, device=device)

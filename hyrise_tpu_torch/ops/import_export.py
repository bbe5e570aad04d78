"""CSV and binary table import and export.

Port of hyrise_tpu/ops/import_export.py (reference:
src/lib/operators/{import_csv,export_csv,import_binary,export_binary}.cpp
and import_export/{csv_meta,csv_parser,binary}.*):

- CSV with an optional `<file>.json` meta file naming each column's type
  and nullability (reference: csv_meta.hpp). Without it the first line
  names the columns and the first data row decides the types.
- A columnar binary form: an .npz container with each column's data,
  validity and dictionary, and a JSON schema (reference:
  import_export/binary.hpp plays the same role).

The files have the JAX package's layout, so either package loads what the
other wrote. Loading uploads to the device the caller names, the card
unless it asks for another.
"""

from __future__ import annotations

import csv as _csv
import json
import os
from typing import List

import numpy as np
import torch

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.load_table import TYPE_NAMES
from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
from hyrise_tpu_torch.types import DataType

_TYPE_NAME = {v: k for k, v in TYPE_NAMES.items()}


def _inferred_type(cell: str) -> DataType:
    for parse, dtype in ((int, DataType.INT32), (float, DataType.FLOAT32)):
        try:
            parse(cell)
            return dtype
        except ValueError:
            pass
    return DataType.STRING


def load_csv(path: str, name: str = "", *, device="cuda") -> Table:
    meta_path = path + ".json"
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    with open(path, newline="") as f:
        rows = list(_csv.reader(f))
    if meta is not None:
        col_meta = meta["columns"]
        names = [c["name"] for c in col_meta]
        dtypes = [TYPE_NAMES[c["type"]] for c in col_meta]
        nullable = [bool(c.get("nullable", False)) for c in col_meta]
        data_rows = rows  # with a meta file, the file has no header line
    else:
        names = rows[0]
        data_rows = rows[1:]
        if data_rows:
            dtypes = [_inferred_type(cell) for cell in data_rows[0]]
        else:
            dtypes = [DataType.STRING] * len(names)
        nullable = [False] * len(names)

    defs = [TableColumnDefinition(n, d, nl) for n, d, nl in zip(names, dtypes, nullable)]
    arrays, validities = [], []
    for i, d in enumerate(defs):
        col = [r[i] for r in data_rows]
        nulls = np.array([c == "" and d.nullable for c in col], dtype=bool)
        if d.dtype is DataType.STRING:
            arrays.append(np.array([None if n else c for c, n in zip(col, nulls)],
                                   dtype=object))
        else:
            parse = int if d.dtype.is_integral else float
            arrays.append(np.array([parse("0" if n else c) for c, n in zip(col, nulls)],
                                   dtype=d.dtype.numpy_dtype))
        validities.append(~nulls if d.nullable else None)
    return Table.from_arrays(name or os.path.basename(path), defs, arrays, validities,
                             device=device)


def export_csv(table: Table, path: str) -> None:
    table = ensure_prefix(table)
    decoded = [c.decode(table.num_rows) for c in table.columns]
    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        for i in range(table.num_rows):
            w.writerow(["" if col[i] is None else col[i] for col in decoded])
    meta = {"columns": [
        {"name": c.name, "type": _TYPE_NAME[c.dtype],
         "nullable": c.validity is not None} for c in table.columns]}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def export_binary(table: Table, path: str) -> None:
    table = ensure_prefix(table)
    n = table.num_rows
    payload = {}
    schema = []
    for i, c in enumerate(table.columns):
        payload[f"data_{i}"] = c.data[:n].cpu().numpy()
        if c.validity is not None:
            payload[f"validity_{i}"] = c.validity[:n].cpu().numpy()
        if c.dictionary is not None:
            payload[f"dict_{i}"] = np.asarray(c.dictionary).astype(str)
        schema.append({"name": c.name, "type": _TYPE_NAME[c.dtype],
                       "nullable": c.validity is not None,
                       "dict": c.dictionary is not None})
    payload["schema"] = np.frombuffer(
        json.dumps({"columns": schema, "num_rows": n}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_binary(path: str, name: str = "", *, device="cuda") -> Table:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        schema = json.loads(bytes(z["schema"]).decode())
        n = schema["num_rows"]
        cols: List[Column] = []
        for i, cs in enumerate(schema["columns"]):
            dtype = TYPE_NAMES[cs["type"]]
            # the JAX package pads its columns; only the first n rows count
            data = np.ascontiguousarray(z[f"data_{i}"][:n], dtype=dtype.numpy_dtype)
            validity = None
            if cs["nullable"]:
                validity = torch.tensor(np.asarray(z[f"validity_{i}"][:n], dtype=bool),
                                        device=device)
            dictionary = z[f"dict_{i}"] if cs["dict"] else None
            cols.append(Column(cs["name"], dtype, torch.tensor(data, device=device),
                               validity, dictionary))
    return Table(cols, n, name=name or os.path.basename(path))


class ImportCsv(AbstractOperator):
    name = "ImportCsv"

    def __init__(self, path: str, table_name: str = "", *, device="cuda"):
        super().__init__()
        self.path = path
        self.table_name = table_name
        self.device = device

    def _on_execute(self, context) -> Table:
        return load_csv(self.path, self.table_name, device=self.device)


class ExportCsv(AbstractOperator):
    name = "ExportCsv"

    def __init__(self, input_op: AbstractOperator, path: str):
        super().__init__(input_op)
        self.path = path

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        export_csv(t, self.path)
        return t


class ImportBinary(AbstractOperator):
    name = "ImportBinary"

    def __init__(self, path: str, table_name: str = "", *, device="cuda"):
        super().__init__()
        self.path = path
        self.table_name = table_name
        self.device = device

    def _on_execute(self, context) -> Table:
        return load_binary(self.path, self.table_name, device=self.device)


class ExportBinary(AbstractOperator):
    name = "ExportBinary"

    def __init__(self, input_op: AbstractOperator, path: str):
        super().__init__(input_op)
        self.path = path

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        export_binary(t, self.path)
        return t

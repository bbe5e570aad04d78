"""SQLite oracle harness.

Copy of hyrise_tpu/utils/sqlite_oracle.py over the port's tables, pinned by
tests/test_torch_utils.py. Reference:
src/test/sql/sqlite_testrunner/sqlite_wrapper.{hpp,cpp} and
src/test/tpc/tpch_test.cpp — the reference loads the same data into an
in-memory SQLite and compares every query's result with relative float
tolerance. Same strategy here.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List

import numpy as np

from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType


def _sqlite_type(dt: DataType) -> str:
    if dt in (DataType.INT32, DataType.INT64):
        return "INTEGER"
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return "REAL"
    return "TEXT"


def load_table_into_sqlite(conn: sqlite3.Connection, name: str, t: Table,
                           batch: int = 100_000) -> None:
    cols = ", ".join(f'"{c.name}" {_sqlite_type(c.dtype)}' for c in t.columns)
    conn.execute(f'CREATE TABLE "{name}" ({cols})')
    placeholders = ", ".join("?" for _ in t.columns)
    if t.live is not None:
        raise ValueError("the oracle loads prefix-layout tables only")
    n = t.num_rows
    decoded = []
    for c in t.columns:
        v = c.decode(n)
        if v.dtype != object:
            # float32 -> python float via float64 for full precision of the
            # stored float32 value
            v = v.astype(np.float64) if v.dtype.kind == "f" else v
        decoded.append(v)
    for start in range(0, n, batch):
        end = min(start + batch, n)
        rows = list(zip(*(col[start:end].tolist() for col in decoded)))
        conn.executemany(f'INSERT INTO "{name}" VALUES ({placeholders})', rows)
    conn.commit()


class SqliteOracle:
    def __init__(self, tables: Dict[str, Table]):
        self.conn = sqlite3.connect(":memory:")
        for name, t in tables.items():
            load_table_into_sqlite(self.conn, name, t)

    def query(self, sql: str) -> List[tuple]:
        cur = self.conn.execute(sql)
        return cur.fetchall()

    def close(self):
        self.conn.close()

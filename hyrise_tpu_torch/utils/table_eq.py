"""Table comparison for tests and oracle harnesses.

Copy of hyrise_tpu/utils/table_eq.py (host-only), pinned by
tests/test_torch_utils.py. Reference:
src/test/testing_assert.hpp:23-89 (`check_table_equal` with
OrderSensitivity, TypeCmpMode, FloatComparisonMode) — the semantics of
EXPECT_TABLE_EQ[_ORDERED/UNORDERED].
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def _normalize_cell(v, float_tol: float):
    if v is None:
        return ("NULL",)
    if isinstance(v, (float,)) or str(type(v)).find("float") >= 0:
        f = float(v)
        if math.isnan(f):
            return ("NaN",)
        return ("f", f)
    try:
        return ("i", int(v))
    except (TypeError, ValueError):
        return ("s", str(v))


def _cells_equal(a, b, rel_tol: float, abs_tol: float) -> bool:
    if a[0] != b[0]:
        # lenient type compare: int vs float compares numerically
        if {a[0], b[0]} == {"i", "f"}:
            return math.isclose(float(a[1]), float(b[1]),
                                rel_tol=rel_tol, abs_tol=abs_tol)
        return False
    if a[0] == "f":
        return math.isclose(a[1], b[1], rel_tol=rel_tol, abs_tol=abs_tol)
    return a[1:] == b[1:]


def _rows_to_cells(rows: Iterable[Sequence], float_tol: float):
    return [tuple(_normalize_cell(v, float_tol) for v in r) for r in rows]


def tables_equal(actual_rows: Iterable[Sequence],
                 expected_rows: Iterable[Sequence],
                 ordered: bool = True,
                 rel_tol: float = 1e-4,
                 abs_tol: float = 1e-6) -> Tuple[bool, str]:
    """Compare row collections; returns (equal, message)."""
    a = _rows_to_cells(actual_rows, rel_tol)
    e = _rows_to_cells(expected_rows, rel_tol)
    if len(a) != len(e):
        return False, f"row count differs: actual {len(a)} vs expected {len(e)}"
    if not ordered:
        # sort both by a canonical key; float tolerance handled by matching
        # after sort on rounded keys — robust enough for test data.
        def key(row):
            return tuple(
                (c[0], round(c[1], 3)) if c[0] == "f" else c for c in row)
        a = sorted(a, key=key)
        e = sorted(e, key=key)
    for i, (ra, re_) in enumerate(zip(a, e)):
        if len(ra) != len(re_):
            return False, f"column count differs in row {i}"
        for j, (ca, ce) in enumerate(zip(ra, re_)):
            if not _cells_equal(ca, ce, rel_tol, abs_tol):
                return False, (f"row {i} col {j} differs: "
                               f"actual {ca} vs expected {ce}\n"
                               f"actual row:   {ra}\nexpected row: {re_}")
    return True, ""


def assert_tables_equal(actual_rows, expected_rows, ordered: bool = True,
                        rel_tol: float = 1e-4, abs_tol: float = 1e-6):
    ok, msg = tables_equal(actual_rows, expected_rows, ordered=ordered,
                           rel_tol=rel_tol, abs_tol=abs_tol)
    assert ok, msg

"""Table/column statistics for cardinality estimation.

Copy of hyrise_tpu/plan/statistics.py; the one difference is that a column's
strided sample is read from its device with one `.cpu()` copy. Reference: src/lib/statistics/ — Selinger-style selectivity estimation
(table_statistics.hpp:17-60 with its magic default selectivities) generated
by scanning tables (generate_table_statistics.*). Used by the predicate
reordering rule and join-input sizing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, PredicateCondition

# reference magic constants (table_statistics.hpp:20-25)
DEFAULT_SELECTIVITY = 0.5
LIKE_SELECTIVITY = 0.1
OPEN_ENDED_SELECTIVITY = 1.0 / 3.0


@dataclasses.dataclass
class ColumnStatistics:
    distinct_count: float
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    null_fraction: float = 0.0
    # For STRING columns (dictionary codes): an evenly spaced sorted sample
    # of the dictionary, so range predicates against string literals can be
    # estimated by rank interpolation (the reference's value-aware estimation
    # in column_statistics.cpp, which our code-space min/max can't provide
    # because literals arrive as strings, not codes).
    quantiles: Optional[list] = None

    def fraction_below(self, value) -> Optional[float]:
        """Estimated fraction of rows with column < value (value-aware
        range estimation, reference: column_statistics.cpp estimate_range)."""
        if self.quantiles:
            q = self.quantiles
            if isinstance(value, str) or isinstance(q[0], str):
                if not isinstance(value, str):
                    return None
                pos = float(np.searchsorted(np.asarray(q, dtype=object),
                                            value))
                return min(max(pos / len(q), 0.0), 1.0)
        if self.min_value is None or self.max_value is None:
            return None
        if isinstance(value, str):
            return None
        try:
            v = float(value)
        except (TypeError, ValueError):
            return None
        if self.max_value <= self.min_value:
            return 0.0 if v <= self.min_value else 1.0
        return min(max((v - self.min_value)
                       / (self.max_value - self.min_value), 0.0), 1.0)


@dataclasses.dataclass
class TableStatistics:
    row_count: float
    columns: Dict[str, ColumnStatistics]

    def column(self, name: str) -> Optional[ColumnStatistics]:
        cs = self.columns.get(name)
        if cs is None and "." in name:
            # SQL plans qualify columns as "alias.column"
            cs = self.columns.get(name.split(".", 1)[1])
        return cs


def generate_table_statistics(table: Table, sample: int = 65536
                              ) -> TableStatistics:
    """Scan (a sample of) the table for per-column stats."""
    n = table.num_rows
    cols: Dict[str, ColumnStatistics] = {}
    step = max(n // sample, 1)
    for c in table.columns:
        if n == 0:
            cols[c.name] = ColumnStatistics(0.0)
            continue
        data = c.data[:n:step].cpu().numpy()  # one host read per column
        quantiles = None
        if c.dtype is DataType.STRING:
            distinct = float(len(c.dictionary))
            mn, mx = 0.0, float(max(len(c.dictionary) - 1, 0))
            if len(c.dictionary):
                # evenly spaced dictionary sample (order-preserving codes ->
                # dictionary rank ~ value rank) for range estimation
                d = np.asarray(c.dictionary)
                idx = np.linspace(0, len(d) - 1,
                                  num=min(len(d), 129)).astype(np.int64)
                quantiles = [str(v) for v in d[idx]]
        else:
            uniq = float(len(np.unique(data)))
            if uniq >= 0.9 * len(data):
                # key-like: nearly all sampled values distinct -> extrapolate
                # linearly (sqrt-style scaling badly underestimates keys and
                # misorders joins)
                distinct = uniq * step
            else:
                # low-cardinality: the sample already saw most values
                distinct = uniq
            mn, mx = float(data.min()), float(data.max())
        nulls = 0.0
        if c.validity is not None:
            nulls = 1.0 - float(c.validity[:n:step].cpu().numpy().mean())
        cols[c.name] = ColumnStatistics(min(distinct, n), mn, mx, nulls,
                                        quantiles)
    return TableStatistics(float(n), cols)


def export_table_statistics(stats: TableStatistics, path: str) -> None:
    """Write statistics as JSON (reference:
    src/lib/statistics/statistics_import_export.cpp — export_table_statistics
    serializes row count + per-column stats)."""
    import json
    doc = {
        "row_count": stats.row_count,
        "columns": {
            name: {
                "distinct_count": cs.distinct_count,
                "min": cs.min_value,
                "max": cs.max_value,
                "null_fraction": cs.null_fraction,
                **({"quantiles": cs.quantiles} if cs.quantiles else {}),
            } for name, cs in stats.columns.items()
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def import_table_statistics(path: str) -> TableStatistics:
    """Reference: statistics_import_export.cpp import_table_statistics."""
    import json
    with open(path) as f:
        doc = json.load(f)
    cols = {
        name: ColumnStatistics(c["distinct_count"], c.get("min"),
                               c.get("max"), c.get("null_fraction", 0.0),
                               c.get("quantiles"))
        for name, c in doc["columns"].items()
    }
    return TableStatistics(float(doc["row_count"]), cols)


def merge_statistics(stats: Dict[str, TableStatistics]) -> TableStatistics:
    """Column-name-keyed union across all tables (TPC-H column prefixes are
    unique per table), for rules that see a predicate without knowing its
    source table (e.g. residual predicates during join reordering)."""
    cols: Dict[str, ColumnStatistics] = {}
    for ts in stats.values():
        for name, cs in ts.columns.items():
            cols.setdefault(name, cs)
    return TableStatistics(0.0, cols)


def estimate_predicate_selectivity(stats: Optional[TableStatistics],
                                   pred: ast.Expr) -> float:
    """Selectivity in [0,1] of a predicate expression (reference:
    column_statistics.cpp estimation logic, simplified)."""
    if isinstance(pred, ast.Logical):
        a = estimate_predicate_selectivity(stats, pred.left)
        b = estimate_predicate_selectivity(stats, pred.right)
        return a * b if pred.op == "and" else min(a + b, 1.0)
    if isinstance(pred, ast.Not):
        return 1.0 - estimate_predicate_selectivity(stats, pred.value)
    if isinstance(pred, ast.Between):
        cs = (stats.column(pred.value.name)
              if stats is not None and isinstance(pred.value, ast.ColumnRef)
              else None)
        if cs is not None and isinstance(pred.lower, ast.Literal) \
                and isinstance(pred.upper, ast.Literal):
            lo = cs.fraction_below(pred.lower.value)
            hi = cs.fraction_below(pred.upper.value)
            if lo is not None and hi is not None:
                return min(max(hi - lo, 0.001), 1.0)
        return OPEN_ENDED_SELECTIVITY ** 2 * 2
    if isinstance(pred, ast.Like):
        return 1.0 - LIKE_SELECTIVITY if pred.negate else LIKE_SELECTIVITY
    if isinstance(pred, ast.IsNull):
        return DEFAULT_SELECTIVITY
    if isinstance(pred, ast.InList):
        base = min(len(pred.options) * 0.05, 0.9)
        return 1.0 - base if pred.negate else base
    if isinstance(pred, ast.Comparison):
        col_stats = None
        literal = None
        cond = pred.cond
        if stats is not None:
            if isinstance(pred.left, ast.ColumnRef):
                col_stats = stats.column(pred.left.name)
                if isinstance(pred.right, ast.Literal):
                    literal = pred.right
            elif isinstance(pred.right, ast.ColumnRef):
                col_stats = stats.column(pred.right.name)
                if isinstance(pred.left, ast.Literal):
                    literal = pred.left
                cond = cond.flipped()  # normalize to col ? literal
        if cond is PredicateCondition.EQUALS:
            if col_stats and col_stats.distinct_count > 0:
                return 1.0 / col_stats.distinct_count
            return 0.1
        if cond is PredicateCondition.NOT_EQUALS:
            if col_stats and col_stats.distinct_count > 0:
                return 1.0 - 1.0 / col_stats.distinct_count
            return 0.9
        # value-aware range estimation (reference: column_statistics.cpp
        # estimate_range_selectivity) when the literal's rank is computable
        if col_stats is not None and literal is not None:
            f = col_stats.fraction_below(literal.value)
            if f is not None:
                if cond in (PredicateCondition.LESS_THAN,
                            PredicateCondition.LESS_THAN_EQUALS):
                    return min(max(f, 0.001), 1.0)
                if cond in (PredicateCondition.GREATER_THAN,
                            PredicateCondition.GREATER_THAN_EQUALS):
                    return min(max(1.0 - f, 0.001), 1.0)
        return OPEN_ENDED_SELECTIVITY
    return DEFAULT_SELECTIVITY

"""Per-block column statistics for scan pruning.

Port of hyrise_tpu/storage/block_statistics.py (reference:
src/lib/statistics/chunk_statistics/: a MinMaxFilter per chunk and column
with can_prune(), consumed by the ChunkPruningRule). The rows of a table
are cut into blocks of `block_rows`; each block keeps, per column, the
minimum and maximum of its values. TableScan (ops/table_scan.py) returns an
empty result at once when keep_mask proves that no block can hold a match.
Alias and a Projection that forwards columns keep the rows where they were,
so they carry the statistics on under the new names (`renamed`): the SQL
path's scans read a stored table through them.

The statistics are made on the table's device, one amin and one amax over
a [blocks, block_rows] view of each column, and then copied to the host
once. They are exact:

- minimums and maximums keep the column's own type, so an INT64 value above
  2^53 is not rounded (as it is in float64);
- NULL rows, dead rows and NaN values take no part in the bounds; a block
  with no other value is `empty`. A NaN matches no comparison, so a block
  is never kept or pruned for one;
- a literal, or a computed value (ast.ComputedValue), is compared as the
  scan compares it (expression/evaluator.py comparison_rule).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.expression.evaluator import comparison_rule
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, PredicateCondition

BLOCK_ROWS = 65536
_PRUNABLE = (PredicateCondition.EQUALS, PredicateCondition.LESS_THAN,
             PredicateCondition.LESS_THAN_EQUALS, PredicateCondition.GREATER_THAN,
             PredicateCondition.GREATER_THAN_EQUALS)


@dataclasses.dataclass
class ColumnBlockStats:
    """Host arrays of n_blocks entries. mins and maxs are in the column's
    dtype (dictionary codes for strings); an empty block holds the type's
    largest value as its minimum and its smallest as its maximum."""

    mins: np.ndarray
    maxs: np.ndarray
    empty: np.ndarray  # bool: no value other than NULL, dead or NaN


def _extremes(dtype: torch.dtype):
    """(largest, smallest) value of a dtype: the fill of an empty block."""
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


@dataclasses.dataclass
class BlockStatistics:
    n_blocks: int
    block_rows: int
    columns: Dict[str, ColumnBlockStats]

    @staticmethod
    def generate(table: Table, block_rows: int = BLOCK_ROWS) -> "BlockStatistics":
        # a prefix table's rows are [0, num_rows); a masked one's may lie
        # anywhere in its capacity
        n = table.num_rows if table.is_prefix else table.capacity
        n_blocks = max(-(-n // block_rows), 1)
        padded = n_blocks * block_rows
        live = table.live_mask()[:n]
        cols: Dict[str, ColumnBlockStats] = {}
        for c in table.columns:
            if c.name in cols:  # a name resolves to its first column
                continue
            data = c.data[:n]
            valid = live if c.validity is None else live & c.validity[:n]
            ordered = valid & ~data.isnan() if data.is_floating_point() else valid
            top, bottom = _extremes(data.dtype)

            def view(t, fill):
                out = torch.full((padded,), fill, dtype=t.dtype, device=t.device)
                out[:n] = t
                return out.view(n_blocks, block_rows)

            mins = view(torch.where(ordered, data, top), top).amin(dim=1)
            maxs = view(torch.where(ordered, data, bottom), bottom).amax(dim=1)
            empty = ~view(ordered, False).any(dim=1)
            cols[c.name] = ColumnBlockStats(mins.cpu().numpy(), maxs.cpu().numpy(),
                                            empty.cpu().numpy())
        return BlockStatistics(n_blocks, block_rows, cols)

    def renamed(self, pairs) -> "BlockStatistics":
        """The statistics of a table that holds the same rows in the same
        places: `pairs` of (old name or None, new name), one per column of
        the new table in order. A name resolves to its first column, as
        Table.column does; a column with no old name has no statistics."""
        cols: Dict[str, ColumnBlockStats] = {}
        named = set()
        for old, new in pairs:
            if new not in named:
                named.add(new)
                if old in self.columns:
                    cols[new] = self.columns[old]
        return BlockStatistics(self.n_blocks, self.block_rows, cols)

    # -- pruning -------------------------------------------------------------

    def keep_mask(self, table: Table, pred: ast.Expr) -> Optional[np.ndarray]:
        """Per block, whether it may hold a row that satisfies `pred`; None
        when these statistics cannot tell (conservative: a conjunction
        prunes by its parts, everything else keeps)."""
        if isinstance(pred, ast.Logical) and pred.op == "and":
            a = self.keep_mask(table, pred.left)
            b = self.keep_mask(table, pred.right)
            if a is None or b is None:
                return a if b is None else b
            return a & b
        if isinstance(pred, ast.Between):
            return self.keep_mask(table, ast.Logical(
                "and",
                ast.Comparison(PredicateCondition.GREATER_THAN_EQUALS, pred.value, pred.lower),
                ast.Comparison(PredicateCondition.LESS_THAN_EQUALS, pred.value, pred.upper)))
        if not isinstance(pred, ast.Comparison) or pred.cond not in _PRUNABLE:
            return None
        if isinstance(pred.left, ast.ColumnRef) and isinstance(pred.right, ast.Literal):
            name, lit, cond = pred.left.name, pred.right, pred.cond
        elif isinstance(pred.right, ast.ColumnRef) and isinstance(pred.left, ast.Literal):
            name, lit, cond = pred.right.name, pred.left, pred.cond.flipped()
        else:
            return None
        value = lit.value
        if name not in self.columns or value is None:
            return None
        st = self.columns[name]
        col = table.column(name)
        if (col.dtype is DataType.STRING) != isinstance(value, str):
            return None
        rule = comparison_rule(col, cond, value, isinstance(lit, ast.ComputedValue))
        if isinstance(rule, bool):
            return ~st.empty if rule else np.zeros(self.n_blocks, dtype=bool)
        cond, v = rule
        # the bounds in the value's type where it is wider (a float32 column
        # against a computed float64 value), whatever numpy's scalar rules
        dt = np.promote_types(st.mins.dtype, np.asarray(v).dtype)
        mins, maxs = st.mins.astype(dt, copy=False), st.maxs.astype(dt, copy=False)
        P = PredicateCondition
        keep = {P.EQUALS: lambda: (mins <= v) & (maxs >= v),
                P.LESS_THAN: lambda: mins < v,
                P.LESS_THAN_EQUALS: lambda: mins <= v,
                P.GREATER_THAN: lambda: maxs > v,
                P.GREATER_THAN_EQUALS: lambda: maxs >= v}[cond]()
        return keep & ~st.empty


def attach_block_statistics(table: Table, block_rows: int = BLOCK_ROWS) -> BlockStatistics:
    """Generate the table's statistics and keep them on it (TableScan reads
    `table.block_stats`)."""
    table.block_stats = BlockStatistics.generate(table, block_rows)
    return table.block_stats

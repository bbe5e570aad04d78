"""TableScan.

Port of hyrise_tpu/ops/table_scan.py (reference:
src/lib/operators/table_scan.cpp:78-164). Every predicate kind is one
compiled expression (expression/evaluator.py does the dictionary ValueID
rewrite for strings) evaluated over the whole column set at once; the
output is the compacted, lazily gathered table of materialize.filter_table.

Block pruning (reference: ChunkPruningRule over chunk statistics): when the
input carries block statistics (storage/block_statistics.py) that prove no
block can hold a match, the scan returns an empty table without touching
the device, and sets performance_data.extra["pruned_all_blocks"].
"""

from __future__ import annotations

import torch

from hyrise_tpu_torch.expression.ast import Expr
from hyrise_tpu_torch.expression.evaluator import compile_expression, make_env
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import filter_table, gather_table
from hyrise_tpu_torch.storage.table import Table


class TableScan(AbstractOperator):
    name = "TableScan"

    def __init__(self, input_op: AbstractOperator, predicate: Expr):
        super().__init__(input_op)
        self.predicate = predicate

    def _on_execute(self, context) -> Table:
        table = self.input_table(0)
        if table.block_stats is not None:
            keep = table.block_stats.keep_mask(table, self.predicate)
            if keep is not None and not keep.any():
                self.performance_data.extra["pruned_all_blocks"] = True
                none = torch.empty(0, dtype=torch.int64, device=table.device)
                return gather_table(table, none)
        ce = compile_expression(self.predicate, table)
        data, validity = ce.fn(make_env(table, ce.required))
        mask = data.bool()
        if validity is not None:
            mask = mask & validity  # NULL predicate result -> row filtered out
        return filter_table(table, mask)

    def describe(self, depth: int = 0) -> str:
        pad = "  " * depth
        lines = [f"{pad}{self.name} {self.predicate} [{self.performance_data}]"]
        for i in self.inputs:
            lines.append(i.describe(depth + 1))
        return "\n".join(lines)

"""Sort operator.

Port of hyrise_tpu/ops/sort.py (reference: src/lib/operators/sort.{hpp,cpp},
stable sort with NULLs first/last, sort.cpp:161-210): multi-column ORDER BY
through one stable permutation (sort_util.sort_permutation), then a lazy
gather of the live rows in that order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import gather_table
from hyrise_tpu_torch.ops.sort_util import sort_permutation
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import SortMode

SortDef = Union[str, Tuple[str, SortMode]]


class Sort(AbstractOperator):
    name = "Sort"

    def __init__(self, input_op: AbstractOperator, sort_defs: Sequence[SortDef]):
        super().__init__(input_op)
        self.sort_defs: List[Tuple[str, SortMode]] = [
            (d, SortMode.ASCENDING) if isinstance(d, str) else d
            for d in sort_defs
        ]

    def _on_execute(self, context) -> Table:
        table = self.input_table(0)
        perm = sort_permutation(table, self.sort_defs)
        # dead rows sort last, so the live rows are the first num_rows
        # and a permutation repeats no row, so unique flags survive; in
        # capacity mode the whole permutation is kept with the device count
        if isinstance(table.num_rows, torch.Tensor):
            return gather_table(table, perm, preserve_unique=True, num_rows=table.num_rows)
        return gather_table(table, perm[:table.num_rows], preserve_unique=True)

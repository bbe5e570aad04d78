"""Print operator: an ASCII dump of a table.

Port of hyrise_tpu/ops/print_op.py (reference: src/lib/operators/print.cpp).
"""

from __future__ import annotations

import sys
from typing import Optional

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.ops.materialize import ensure_prefix
from hyrise_tpu_torch.storage.table import Table


def format_table(t: Table, max_rows: Optional[int] = 50) -> str:
    prefix = ensure_prefix(t)
    n = t.num_rows if max_rows is None else min(t.num_rows, max_rows)
    decoded = [c.decode(n) for c in prefix.columns]
    headers = [c.name for c in t.columns]
    types = [c.dtype.value for c in t.columns]
    cells = [[("NULL" if col[i] is None else str(col[i])) for col in decoded]
             for i in range(n)]
    widths = [max(len(h), len(ty), *(len(r[j]) for r in cells)) if cells
              else max(len(h), len(ty))
              for j, (h, ty) in enumerate(zip(headers, types))]

    def row(vals):
        return "|" + "|".join(f" {v:>{w}} " for v, w in zip(vals, widths)) + "|"

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep, row(headers), row(types), sep]
    lines += [row(r) for r in cells]
    lines.append(sep)
    if n < t.num_rows:
        lines.append(f"... ({t.num_rows} rows total)")
    else:
        lines.append(f"({t.num_rows} rows)")
    return "\n".join(lines)


class Print(AbstractOperator):
    name = "Print"

    def __init__(self, input_op: AbstractOperator, out=None,
                 max_rows: Optional[int] = 50):
        super().__init__(input_op)
        self.out = out
        self.max_rows = max_rows

    def _on_execute(self, context) -> Table:
        t = self.input_table(0)
        print(format_table(t, self.max_rows),
              file=self.out if self.out is not None else sys.stdout)
        return t

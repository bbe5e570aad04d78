"""Projection.

Port of hyrise_tpu/ops/projection.py (reference:
src/lib/operators/projection.cpp:52-80): evaluate each output expression
over the input's tensors; a bare ColumnRef forwards the input column without
copying.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from hyrise_tpu_torch.expression.ast import ColumnRef, Expr
from hyrise_tpu_torch.expression.evaluator import compile_expression, make_env
from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.storage.column import Column
from hyrise_tpu_torch.storage.table import Table

# Each output is either "name" (forward column), an Expr (auto-named), or
# (name, Expr).
OutputSpec = Union[str, Expr, Tuple[str, Expr]]


class Projection(AbstractOperator):
    name = "Projection"

    def __init__(self, input_op: AbstractOperator, outputs: Sequence[OutputSpec]):
        super().__init__(input_op)
        self.outputs = list(outputs)

    def _on_execute(self, context) -> Table:
        table = self.input_table(0)
        cols: List[Column] = []
        for spec in self.outputs:
            if isinstance(spec, str):
                cols.append(table.column(spec))
                continue
            if isinstance(spec, tuple):
                name, expr = spec
            else:
                name, expr = repr(spec), spec
            if isinstance(expr, ColumnRef):
                cols.append(table.column(expr.name).with_name(name))
                continue
            ce = compile_expression(expr, table)
            data, validity = ce.fn(make_env(table, ce.required))
            if ce.is_bool:
                data = data.to(torch.int32)  # SQL exposes predicates as 0/1
            cols.append(Column(name=name, dtype=ce.dtype, data=data,
                               validity=validity, dictionary=ce.dictionary))
        return Table(cols, table.num_rows, name=table.name, live=table.live)

"""Physical operator base.

Port of hyrise_tpu/ops/base.py (reference:
src/lib/operators/abstract_operator.hpp:56-172): an operator has up to two
input operators, executes once, caches one output Table, and records its
wall-clock time. `execute_plan` runs a plan recursively on one thread.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from hyrise_tpu_torch.storage.table import Table


class OperatorPerformanceData:
    """Reference: src/lib/operators/operator_performance_data.hpp:12-19."""

    def __init__(self) -> None:
        self.walltime_s: float = 0.0

    def __repr__(self) -> str:
        return f"{self.walltime_s * 1e3:.3f}ms"


class AbstractOperator:
    name = "AbstractOperator"

    def __init__(self, *inputs: "AbstractOperator") -> None:
        assert len(inputs) <= 2
        self.inputs: List[AbstractOperator] = list(inputs)
        self._output: Optional[Table] = None
        self.performance_data = OperatorPerformanceData()

    @property
    def left_input(self) -> "AbstractOperator":
        return self.inputs[0]

    @property
    def right_input(self) -> "AbstractOperator":
        return self.inputs[1]

    def input_table(self, side: int = 0) -> Table:
        out = self.inputs[side].get_output()
        assert out is not None, f"input {side} of {self.name} not executed"
        return out

    def execute(self, context=None) -> Table:
        if self._output is not None:
            return self._output
        t0 = time.perf_counter()
        self._output = self._on_execute(context)
        device = self._output.device
        if device.type == "cuda":
            # Wait for the device so walltime measures the operator's device
            # work, like the reference's per-operator timing. Lazy (not yet
            # materialized) columns are not forced: their cost lands on the
            # operator that first reads them.
            torch.cuda.synchronize(device)
        self.performance_data.walltime_s = time.perf_counter() - t0
        return self._output

    def get_output(self) -> Optional[Table]:
        return self._output

    def clear_output(self) -> None:
        """Reference: OperatorTask drains predecessors (operator_task.cpp:100-117)."""
        self._output = None

    def _on_execute(self, context) -> Table:
        raise NotImplementedError

    def describe(self, depth: int = 0) -> str:
        pad = "  " * depth
        lines = [f"{pad}{self.name} [{self.performance_data}]"]
        for i in self.inputs:
            lines.append(i.describe(depth + 1))
        return "\n".join(lines)


def execute_plan(root: AbstractOperator, context=None) -> Table:
    """Post-order recursive execution on one thread."""
    seen = set()

    def walk(op: AbstractOperator):
        if id(op) in seen:
            return
        seen.add(id(op))
        for i in op.inputs:
            walk(i)
        op.execute(context)

    walk(root)
    return root.get_output()

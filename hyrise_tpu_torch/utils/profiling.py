"""Per-operator profiling report.

Port of hyrise_tpu/utils/profiling.py (reference: OperatorPerformanceData
captured in AbstractOperator::execute(), operator_performance_data.hpp:12-19,
the PQP visualizer's walltime annotations and SQLPipelineMetrics): a table
over an executed physical plan with each operator's walltime, output rows,
bytes produced and an effective-bandwidth roofline column. An operator's
walltime (`performance_data.walltime_s`) ends after a
`torch.cuda.synchronize()` on CUDA while spans are recorded (ops/base.py),
so it covers its device work where the plan ran inside
`utils.spans.recording()`; otherwise it is the host's part.
"""

from __future__ import annotations

from typing import List

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.utils.timer import format_bytes, format_duration

# NVIDIA H100 SXM (80 GB HBM3): device memory rate from its data sheet, the
# bound PERF.md's kernel table uses
HBM_PEAK_GBPS = 3350.0


def _output_bytes(op: AbstractOperator) -> int:
    t = op.get_output()
    if t is None:
        return 0
    total = 0
    for c in t.columns:
        if c.is_lazy:
            continue  # never materialized: no bytes produced
        total += c.data.numel() * c.data.element_size()
        if c.has_validity:
            total += c.validity.numel()
    return total


def plan_profile(root: AbstractOperator) -> List[dict]:
    """Post-order rows: one dict per operator."""
    rows: List[dict] = []
    seen = set()

    def walk(op: AbstractOperator):
        if id(op) in seen:
            return
        seen.add(id(op))
        for c in op.inputs:
            walk(c)
        out = op.get_output()
        wall = op.performance_data.walltime_s
        nbytes = _output_bytes(op)
        rows.append({
            "operator": op.name,
            "walltime_s": wall,
            "output_rows": out.num_rows if out is not None else None,
            "output_bytes": nbytes,
            "effective_gbps": (nbytes / wall / 1e9) if wall > 0 else 0.0,
            "extra": dict(op.performance_data.extra),
        })

    walk(root)
    return rows


def format_profile(root: AbstractOperator) -> str:
    rows = plan_profile(root)
    total = sum(r["walltime_s"] for r in rows)
    lines = [f"{'operator':<22} {'wall':>10} {'rows':>10} {'out':>10} "
             f"{'GB/s':>7} {'%peak':>6}"]
    for r in rows:
        pct = 100.0 * r["effective_gbps"] / HBM_PEAK_GBPS
        lines.append(
            f"{r['operator']:<22} {format_duration(r['walltime_s']):>10} "
            f"{str(r['output_rows']):>10} "
            f"{format_bytes(r['output_bytes']):>10} "
            f"{r['effective_gbps']:>7.1f} {pct:>5.1f}%")
    lines.append(f"{'TOTAL':<22} {format_duration(total):>10}")
    return "\n".join(lines)

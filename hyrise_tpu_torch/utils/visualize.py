"""Plan visualization.

Port of hyrise_tpu/utils/visualize.py (reference: src/lib/planviz/ —
AbstractVisualizer over graphviz, lqp_visualizer.*,
sql_query_plan_visualizer.*): LQP and PQP as graphviz dot text, the PQP
annotated with operator walltimes, rendered with the `dot` binary where it
is installed.
"""

from __future__ import annotations

import html
import shutil
import subprocess
from typing import Optional

from hyrise_tpu_torch.ops.base import AbstractOperator
from hyrise_tpu_torch.plan.lqp import LQPNode


def _dot_escape(s: str) -> str:
    return html.escape(str(s)).replace("\n", "\\n")


def lqp_to_dot(root: LQPNode) -> str:
    """Reference: LQPVisualizer."""
    lines = ["digraph LQP {", "  node [shape=box, fontname=monospace];"]
    seen = {}

    def walk(n: LQPNode) -> str:
        if id(n) in seen:
            return seen[id(n)]
        name = f"n{len(seen)}"
        seen[id(n)] = name
        lines.append(f'  {name} [label="{_dot_escape(repr(n))}"];')
        for c in n.children:
            cn = walk(c)
            lines.append(f"  {cn} -> {name};")
        return name

    walk(root)
    lines.append("}")
    return "\n".join(lines)


def pqp_to_dot(root: AbstractOperator) -> str:
    """Reference: SQLQueryPlanVisualizer — operators annotated with
    walltimes."""
    lines = ["digraph PQP {", "  node [shape=box, fontname=monospace];"]
    seen = {}

    def walk(op: AbstractOperator) -> str:
        if id(op) in seen:
            return seen[id(op)]
        name = f"n{len(seen)}"
        seen[id(op)] = name
        wall = op.performance_data.walltime_s * 1e3
        rows = ""
        if op.get_output() is not None:
            rows = f"\\n{op.get_output().num_rows} rows"
        lines.append(
            f'  {name} [label="{_dot_escape(op.name)}\\n{wall:.2f}ms{rows}"];')
        for c in op.inputs:
            cn = walk(c)
            lines.append(f"  {cn} -> {name};")
        return name

    walk(root)
    lines.append("}")
    return "\n".join(lines)


def render_dot(dot: str, path: str) -> Optional[str]:
    """Render dot text to `path`.png where graphviz's `dot` is installed and
    return that path; else write the text to `path`.dot and return that."""
    if shutil.which("dot"):
        out = path if path.endswith(".png") else path + ".png"
        p = subprocess.run(["dot", "-Tpng", "-o", out], input=dot.encode(),
                           capture_output=True)
        if p.returncode == 0:
            return out
    out = path if path.endswith(".dot") else path + ".dot"
    with open(out, "w") as f:
        f.write(dot)
    return out

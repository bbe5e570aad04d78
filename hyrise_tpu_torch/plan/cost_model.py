"""Cost models.

Reference: src/lib/cost_model/ — AbstractCostModel + CostModelLogical: a
feature-proxy abstraction estimating operator cost from input cardinalities
(scaffolding in the reference, used experimentally). Ours estimates device
cost in bytes streamed from device memory per LQP node, using
plan/statistics cardinality estimates.
"""

from __future__ import annotations

from typing import Dict, Optional

from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.statistics import (TableStatistics,
                                        estimate_predicate_selectivity)


class AbstractCostModel:
    def estimate_plan_cost(self, node: L.LQPNode) -> float:
        cost = self.estimate_node_cost(node)
        for c in node.children:
            cost += self.estimate_plan_cost(c)
        return cost

    def estimate_node_cost(self, node: L.LQPNode) -> float:
        raise NotImplementedError


class CostModelLogical(AbstractCostModel):
    """Bytes-streamed proxy: each operator's cost ~ rows in + rows out,
    scaled by a per-operator factor (joins sort the build side -> log
    factor; aggregates sort-cluster -> log factor)."""

    ROW_BYTES = 32  # proxy width

    def __init__(self, stats: Optional[Dict[str, TableStatistics]] = None):
        self.stats = stats or {}

    # -- cardinality estimation ---------------------------------------------

    def estimate_cardinality(self, node: L.LQPNode) -> float:
        if isinstance(node, L.StoredTableNode):
            st = self.stats.get(node.table_name)
            return st.row_count if st is not None else 1e4
        if isinstance(node, L.StaticTableNode):
            return float(node.table.num_rows)
        if isinstance(node, L.PredicateNode):
            child = self.estimate_cardinality(node.children[0])
            st = self._leaf_stats(node)
            return child * estimate_predicate_selectivity(st, node.predicate)
        if isinstance(node, L.JoinNode):
            from hyrise_tpu_torch.types import (ANTI_MODES, EXISTENCE_MODES, JoinMode)
            l = self.estimate_cardinality(node.children[0])
            r = self.estimate_cardinality(node.children[1])
            if node.mode is JoinMode.CROSS:
                return l * r
            if node.mode in EXISTENCE_MODES:
                return l * 0.5
            return max(l, r)  # equi-join PK-FK assumption
        if isinstance(node, L.AggregateNode):
            child = self.estimate_cardinality(node.children[0])
            if not node.groupby:
                return 1.0
            return max(child * 0.1, 1.0)
        if isinstance(node, L.LimitNode):
            return min(self.estimate_cardinality(node.children[0]), node.n)
        if node.children:
            return self.estimate_cardinality(node.children[0])
        return 1.0

    def _leaf_stats(self, node: L.LQPNode) -> Optional[TableStatistics]:
        while node.children:
            node = node.children[0]
        if isinstance(node, L.StoredTableNode):
            return self.stats.get(node.table_name)
        return None

    # -- cost ----------------------------------------------------------------

    def estimate_node_cost(self, node: L.LQPNode) -> float:
        import math

        rows_in = sum(self.estimate_cardinality(c) for c in node.children)
        rows_out = self.estimate_cardinality(node)
        factor = 1.0
        if isinstance(node, L.JoinNode):
            factor = math.log2(max(rows_in, 2.0))
        elif isinstance(node, (L.AggregateNode, L.SortNode, L.DistinctNode)):
            factor = math.log2(max(rows_in, 2.0))
        return (rows_in * factor + rows_out) * self.ROW_BYTES

"""Greedy join-order optimization.

The reference's join ordering was work-in-progress (its TPC-H texts carry
"changed ordering in the FROM clause ... as soon as join ordering is fixed"
notes, tpch_queries.cpp). This module implements the classic Greedy Operator
Ordering (GOO) over maximal inner-equi-join regions:

1. extract a join region: relations (arbitrary subplans), equality edges
   (from join conditions AND equality filter predicates), and residual
   predicates;
2. repeatedly join the pair with the smallest estimated output
   (|A ⋈ B| = |A|·|B| / max(nd(a), nd(b))), preferring connected pairs;
3. reattach every residual predicate at the lowest point where its columns
   are available; the smaller input goes to the build (right) side — the
   reference's JoinHash swap rule (join_hash.cpp:55-76).

Only INNER equi joins are reordered; outer/semi/anti/non-equi structures are
left untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.optimizer import _output_columns
from hyrise_tpu_torch.plan.statistics import (TableStatistics,
                                        estimate_predicate_selectivity,
                                        merge_statistics)
from hyrise_tpu_torch.types import (ANTI_MODES, EXISTENCE_MODES, JoinMode, PredicateCondition)


@dataclasses.dataclass
class _Relation:
    node: L.LQPNode
    columns: Set[str]
    rows: float


class JoinOrderingRule:
    def __init__(self, stats: Optional[Dict[str, TableStatistics]] = None):
        self.stats = stats or {}
        self._merged = merge_statistics(self.stats)

    # -- statistics helpers --------------------------------------------------

    def _distinct_of(self, name: str) -> float:
        bare = name.split(".", 1)[1] if "." in name else name
        best = 1.0
        for ts in self.stats.values():
            cs = ts.columns.get(bare)
            if cs is not None:
                best = max(best, cs.distinct_count)
        return best

    def _estimate_rows(self, node: L.LQPNode, catalog) -> float:
        if isinstance(node, L.StoredTableNode):
            ts = None
            for name, t in self.stats.items():
                if name == node.table_name:
                    ts = t
            if ts is not None:
                return max(ts.row_count, 1.0)
            if catalog is not None and catalog.has_table(node.table_name):
                return max(float(catalog.get_table(node.table_name).num_rows),
                           1.0)
            return 1e4
        if isinstance(node, L.StaticTableNode):
            return max(float(node.table.num_rows), 1.0)
        if isinstance(node, L.PredicateNode):
            leaf = node
            while leaf.children:
                leaf = leaf.children[0]
            ts = self.stats.get(getattr(leaf, "table_name", None)) \
                or self._merged
            sel = estimate_predicate_selectivity(ts, node.predicate)
            return max(self._estimate_rows(node.children[0], catalog) * sel,
                       1.0)
        if isinstance(node, L.AggregateNode):
            base = self._estimate_rows(node.children[0], catalog)
            return max(base * 0.1, 1.0) if node.groupby else 1.0
        if isinstance(node, L.JoinNode):
            l = self._estimate_rows(node.children[0], catalog)
            r = self._estimate_rows(node.children[1], catalog)
            if node.mode in EXISTENCE_MODES:
                return max(l * 0.5, 1.0)
            if node.mode is JoinMode.CROSS:
                return l * r
            nd = max(self._distinct_of(node.left_col or ""),
                     self._distinct_of(node.right_col or ""), 1.0)
            return max(l * r / nd, 1.0)
        if node.children:
            return self._estimate_rows(node.children[0], catalog)
        return 1.0

    # -- region extraction ---------------------------------------------------

    def _extract(self, node: L.LQPNode, catalog, relations, edges, preds
                 ) -> bool:
        """Flatten node into the region accumulators. Returns True if the
        node was decomposed (joins/predicates), False if it is a relation."""
        is_inner_equi = (isinstance(node, L.JoinNode)
                         and node.mode is JoinMode.INNER
                         and node.cond is PredicateCondition.EQUALS
                         and node.left_col)
        is_cross = (isinstance(node, L.JoinNode)
                    and node.mode is JoinMode.CROSS)
        if is_inner_equi or is_cross:
            # flatten CROSS joins too: un-convertible FROM-order crosses
            # (e.g. part x supplier, connected only through lineitem) must
            # become separate relations so GOO can route them via their
            # real edges instead of materializing the cross product
            left, right = node.children
            if not self._extract(left, catalog, relations, edges, preds):
                self._add_relation(left, catalog, relations)
            if not self._extract(right, catalog, relations, edges, preds):
                self._add_relation(right, catalog, relations)
            if is_inner_equi:
                edges.append((node.left_col, node.right_col))
            return True
        if isinstance(node, L.PredicateNode):
            child_decomposed = self._extract(node.children[0], catalog,
                                             relations, edges, preds)
            if not child_decomposed:
                return False  # keep predicate attached to its relation
            p = node.predicate
            if isinstance(p, ast.Comparison) and \
                    p.cond is PredicateCondition.EQUALS and \
                    isinstance(p.left, ast.ColumnRef) and \
                    isinstance(p.right, ast.ColumnRef):
                edges.append((p.left.name, p.right.name))
            else:
                preds.append(p)
            return True
        return False

    def _add_relation(self, node: L.LQPNode, catalog, relations) -> None:
        cols = _output_columns(node, catalog)
        relations.append(_Relation(node, set(cols) if cols else set(),
                                   self._estimate_rows(node, catalog)))

    # -- GOO -----------------------------------------------------------------

    def _reorder(self, relations: List[_Relation],
                 edges: List[Tuple[str, str]],
                 preds: List[ast.Expr], catalog) -> L.LQPNode:
        comps: List[_Relation] = list(relations)
        pending_edges = list(edges)
        pending_preds = list(preds)

        def attachable(rel: _Relation):
            nonlocal pending_preds, pending_edges
            changed = True
            while changed:
                changed = False
                for p in list(pending_preds):
                    if set(p.columns()) <= rel.columns:
                        rel.node = L.PredicateNode(p, rel.node)
                        rel.rows = max(
                            rel.rows * estimate_predicate_selectivity(
                                self._merged, p),
                            1.0)
                        # identity-based removal: Expr overloads __eq__ to
                        # BUILD comparison nodes, so list.remove() would
                        # delete the wrong (first) element
                        pending_preds[:] = [q for q in pending_preds
                                            if q is not p]
                        changed = True
                # an edge whose two columns are inside ONE component becomes
                # a filter (duplicate equality like c_nationkey=s_nationkey)
                for (a, b) in list(pending_edges):
                    if a in rel.columns and b in rel.columns:
                        rel.node = L.PredicateNode(
                            ast.Comparison(PredicateCondition.EQUALS,
                                           ast.col(a), ast.col(b)), rel.node)
                        rel.rows = max(rel.rows / max(
                            min(self._distinct_of(a), self._distinct_of(b)),
                            1.0), 1.0)
                        pending_edges.remove((a, b))
                        changed = True

        for r in comps:
            attachable(r)

        while len(comps) > 1:
            best = None  # (est, i, j, lcol, rcol)
            for (a, b) in pending_edges:
                i = j = None
                for idx, r in enumerate(comps):
                    if a in r.columns:
                        i = idx
                    if b in r.columns:
                        j = idx
                if i is None or j is None or i == j:
                    continue
                nd = max(self._distinct_of(a), self._distinct_of(b), 1.0)
                est = comps[i].rows * comps[j].rows / nd
                if best is None or est < best[0]:
                    best = (est, i, j, a, b)
            if best is None:
                # disconnected: cross join the two smallest components
                comps.sort(key=lambda r: r.rows)
                i, j = 0, 1
                a = b = None
                est = comps[i].rows * comps[j].rows
                best = (est, i, j, a, b)
            est, i, j, a, b = best
            ri, rj = comps[i], comps[j]
            # smaller side becomes the build (right) input
            if ri.rows < rj.rows:
                ri, rj = rj, ri
                a, b = (b, a) if a is not None else (a, b)
            if a is None:
                node = L.JoinNode(JoinMode.CROSS, ri.node, rj.node)
            else:
                lc, rc = (a, b) if a in ri.columns else (b, a)
                node = L.JoinNode(JoinMode.INNER, ri.node, rj.node, lc, rc)
                pending_edges.remove((a, b) if (a, b) in pending_edges
                                     else (b, a))
            merged = _Relation(node, ri.columns | rj.columns, max(est, 1.0))
            comps = [c for k, c in enumerate(comps) if k not in (i, j)]
            attachable(merged)
            comps.append(merged)

        out = comps[0]
        for p in pending_preds:  # anything left (shouldn't happen) goes on top
            out.node = L.PredicateNode(p, out.node)
        return out.node

    # -- entry ---------------------------------------------------------------

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        seen = set()

        def walk(n: L.LQPNode) -> L.LQPNode:
            if id(n) in seen:
                return n
            seen.add(id(n))
            relations: List[_Relation] = []
            edges: List[Tuple[str, str]] = []
            preds: List[ast.Expr] = []
            if self._extract(n, catalog, relations, edges, preds) and \
                    len(relations) >= 3:
                for r in relations:
                    r.node = walk(r.node)
                    r.columns = set(_output_columns(r.node, catalog) or
                                    r.columns)
                return self._reorder(relations, edges, preds, catalog)
            n.children = [walk(c) for c in n.children]
            return n

        return walk(root)

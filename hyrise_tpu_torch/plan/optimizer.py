"""Rule-based LQP optimizer.

Port of hyrise_tpu/plan/optimizer.py. Reference:
src/lib/optimizer/optimizer.cpp:83-144 — rule batches:
Once{ColumnPruning}, Iterative<=100{PredicatePushdown, PredicateReordering,
JoinDetection}, Once{ChunkPruning, ConstantCalculation}.

Implemented rules:
- ConstantCalculationRule: fold literal-only arithmetic subtrees.
- JoinDetectionRule: CROSS join + equality predicate across sides -> equi
  join (reference: strategy/join_detection_rule.cpp).
- PredicatePushdownRule: push predicates below projections/sorts and into
  join sides whose columns satisfy them (strategy/predicate_pushdown_rule).
- PredicateReorderingRule: order consecutive predicates by estimated
  selectivity, most selective first (strategy/predicate_reordering_rule).
- ColumnPruningRule: prune unused stored-table columns (projection insertion
  at the leaves; strategy/column_pruning_rule).
- IndexScanRule: mark predicates over a stored table whose column has an
  index (strategy/index_scan_rule.cpp); the translator lowers them to
  IndexScan. Unlike the JAX package's rule, it also looks through the
  AliasNode of qualified names that the SQL translator puts over every
  stored table, so SQL statements reach their indexes.

Block/chunk pruning (reference ChunkPruningRule) is no plan rewrite here:
TableScan consults the block statistics of the table it reads
(storage/block_statistics.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.plan.statistics import (TableStatistics,
                                        estimate_predicate_selectivity)
from hyrise_tpu_torch.types import (ANTI_MODES, EXISTENCE_MODES, JoinMode, PredicateCondition)


# ---------------------------------------------------------------------------
# helpers

def _output_columns(node: L.LQPNode, catalog) -> Optional[List[str]]:
    """Best-effort output column list of an LQP node (None = unknown)."""
    if isinstance(node, L.StoredTableNode):
        if node.pruned_columns is not None:
            return list(node.pruned_columns)
        if catalog is not None and catalog.has_table(node.table_name):
            return catalog.get_table(node.table_name).column_names
        return None
    if isinstance(node, L.StaticTableNode):
        return node.table.column_names
    if isinstance(node, L.ProjectionNode):
        return [o if isinstance(o, str) else o[0] for o in node.outputs]
    if isinstance(node, L.AggregateNode):
        return list(node.groupby) + [n for n, _ in node.aggregates]
    if isinstance(node, L.AliasNode):
        if node.sources is not None:
            return list(node.names)
        child = _output_columns(node.children[0], catalog)
        return list(node.names) if child is not None else list(node.names)
    if isinstance(node, L.JoinNode):
        l = _output_columns(node.children[0], catalog)
        r = _output_columns(node.children[1], catalog)
        if node.mode in EXISTENCE_MODES:
            return l
        if l is None or r is None:
            return None
        return l + r
    if isinstance(node, (L.PredicateNode, L.SortNode, L.LimitNode,
                         L.ValidateNode, L.DistinctNode)):
        return _output_columns(node.children[0], catalog)
    if isinstance(node, L.UnionNode):
        return _output_columns(node.children[0], catalog)
    return None


# ---------------------------------------------------------------------------
# rules

class ConstantCalculationRule:
    """Fold arithmetic over literals inside all expressions."""

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        def fold_expr(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.Arithmetic):
                l, r = fold_expr(e.left), fold_expr(e.right)
                if isinstance(l, ast.Literal) and isinstance(r, ast.Literal) \
                        and l.value is not None and r.value is not None \
                        and not isinstance(l.value, str):
                    try:
                        v = {"+": lambda a, b: a + b,
                             "-": lambda a, b: a - b,
                             "*": lambda a, b: a * b,
                             "/": lambda a, b: a / b if b else 0,
                             "%": lambda a, b: a % b if b else 0}[e.op](
                                 l.value, r.value)
                        return ast.Literal(v)
                    except Exception:
                        pass
                e.left, e.right = l, r
                return e
            for attr in ("left", "right", "value", "lower", "upper"):
                if hasattr(e, attr) and isinstance(getattr(e, attr), ast.Expr):
                    setattr(e, attr, fold_expr(getattr(e, attr)))
            return e

        def visit(n: L.LQPNode) -> L.LQPNode:
            if isinstance(n, L.PredicateNode):
                n.predicate = fold_expr(n.predicate)
            if isinstance(n, L.ProjectionNode):
                n.outputs = [o if isinstance(o, str) else (o[0], fold_expr(o[1]))
                             for o in n.outputs]
            return n

        return L.map_lqp(root, visit)


class DisjunctionInferenceRule:
    """Derive pushable implied predicates from OR-of-AND predicates.

    (a=1 AND b=2) OR (a=3 AND c=4)  implies  a IN (1, 3): any column
    constrained by EQUALS/IN literals in EVERY branch yields a necessary
    IN-list that pushdown can move to the column's relation — the standard
    rewrite behind TPC-H Q7's nation pairs and Q19's brand/container OR.
    The original predicate is kept (the implication is necessary, not
    sufficient)."""

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        def branch_constraints(e) -> Optional[Dict[str, Set]]:
            """column -> set of literal values, for one OR branch."""
            if isinstance(e, ast.Logical) and e.op == "and":
                a = branch_constraints(e.left)
                b = branch_constraints(e.right)
                out: Dict[str, Set] = {}
                for d in (a, b):
                    if d:
                        for k, v in d.items():
                            out.setdefault(k, set()).update(v)
                return out
            if isinstance(e, ast.Comparison) and \
                    e.cond is PredicateCondition.EQUALS:
                if isinstance(e.left, ast.ColumnRef) and \
                        isinstance(e.right, ast.Literal):
                    return {e.left.name: {e.right.value}}
                if isinstance(e.right, ast.ColumnRef) and \
                        isinstance(e.left, ast.Literal):
                    return {e.right.name: {e.left.value}}
            if isinstance(e, ast.InList) and not e.negate and \
                    isinstance(e.value, ast.ColumnRef) and \
                    all(isinstance(o, ast.Literal) for o in e.options):
                return {e.value.name: {o.value for o in e.options}}
            return {}

        def or_branches(e):
            if isinstance(e, ast.Logical) and e.op == "or":
                return or_branches(e.left) + or_branches(e.right)
            return [e]

        def visit(n: L.LQPNode) -> L.LQPNode:
            if not isinstance(n, L.PredicateNode):
                return n
            if getattr(n, "_dij_done", False):
                return n
            branches = or_branches(n.predicate)
            if len(branches) < 2:
                return n
            per_branch = [branch_constraints(b) for b in branches]
            common = set(per_branch[0]) if per_branch[0] else set()
            for d in per_branch[1:]:
                common &= set(d) if d else set()
            out = n
            n._dij_done = True
            for colname in sorted(common):
                values = set()
                for d in per_branch:
                    values |= d[colname]
                implied = ast.InList(ast.col(colname),
                                     [ast.lit(v) for v in sorted(values)])
                out = L.PredicateNode(implied, out)
                out._dij_done = True
            return out

        return L.map_lqp(root, visit)


class JoinDetectionRule:
    """Predicate(l == r) over CrossJoin -> equi JoinNode when l and r come
    from different sides (reference: strategy/join_detection_rule.cpp).

    When a STACK of predicates sits above a cross join and several are
    cross-side equalities, the chosen join condition matters enormously:
    joining on a low-cardinality column (c_nationkey = s_nationkey) explodes
    the output, while a key column (l_suppkey = s_suppkey) stays linear.
    With statistics available we pick the equality whose columns have the
    highest distinct counts; the remaining conjuncts stay as filters."""

    def __init__(self, stats: Optional[Dict[str, "TableStatistics"]] = None):
        self.stats = stats or {}

    def _distinct_of(self, name: str) -> float:
        bare = name.split(".", 1)[1] if "." in name else name
        best = 1.0
        for ts in self.stats.values():
            cs = ts.columns.get(bare)
            if cs is not None:
                best = max(best, cs.distinct_count)
        return best

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        # TOP-DOWN so the full Predicate* chain above each cross join is
        # visible at once (bottom-up rewriting would convert on the lowest
        # predicate before alternatives can be compared).
        seen = set()

        def walk(n: L.LQPNode) -> L.LQPNode:
            if id(n) in seen:
                return n
            seen.add(id(n))
            n = self._try_convert(n, catalog)
            n.children = [walk(c) for c in n.children]
            return n

        return walk(root)

    def _try_convert(self, n: L.LQPNode, catalog) -> L.LQPNode:
        if not isinstance(n, L.PredicateNode):
            return n
        # collect the full predicate chain ending at a CROSS join
        chain = [n]
        cur = n
        while isinstance(cur.children[0], L.PredicateNode):
            cur = cur.children[0]
            chain.append(cur)
        if not (isinstance(cur.children[0], L.JoinNode)
                and cur.children[0].mode is JoinMode.CROSS):
            return n
        join = cur.children[0]
        lcols = _output_columns(join.children[0], catalog)
        rcols = _output_columns(join.children[1], catalog)
        if lcols is None or rcols is None:
            return n
        lset, rset = set(lcols), set(rcols)

        candidates = []  # (score, pred_node, lc, rc)
        for pn in chain:
            p = pn.predicate
            if not (isinstance(p, ast.Comparison)
                    and p.cond is PredicateCondition.EQUALS
                    and isinstance(p.left, ast.ColumnRef)
                    and isinstance(p.right, ast.ColumnRef)):
                continue
            a, b = p.left.name, p.right.name
            if a in lset and b in rset:
                lc, rc = a, b
            elif b in lset and a in rset:
                lc, rc = b, a
            else:
                continue
            score = min(self._distinct_of(lc), self._distinct_of(rc))
            candidates.append((score, pn, lc, rc))
        if not candidates:
            return n
        candidates.sort(key=lambda x: -x[0])
        _, chosen, lc, rc = candidates[0]
        new_join = L.JoinNode(JoinMode.INNER, join.children[0],
                              join.children[1], lc, rc)
        # rebuild remaining predicates above the join
        out: L.LQPNode = new_join
        for pn in reversed(chain):
            if pn is chosen:
                continue
            pn.children[0] = out
            out = pn
        return out



class PredicatePushdownRule:
    """Push PredicateNodes toward the leaves."""

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        changed = [True]

        def visit(n: L.LQPNode) -> L.LQPNode:
            if not isinstance(n, L.PredicateNode):
                return n
            child = n.children[0]
            needed = set(n.predicate.columns())
            # below Sort / Validate / another-predicate reordering is handled
            # elsewhere; push below Sort and Alias-free Projections
            if isinstance(child, L.SortNode):
                n.children[0] = child.children[0]
                child.children[0] = n
                changed[0] = True
                return child
            if isinstance(child, L.ProjectionNode):
                # only if all needed columns are pass-through names
                passthrough = {o for o in child.outputs if isinstance(o, str)}
                passthrough |= {o[0] for o in child.outputs
                                if not isinstance(o, str)
                                and isinstance(o[1], ast.ColumnRef)
                                and o[0] == o[1].name}
                if needed <= passthrough:
                    n.children[0] = child.children[0]
                    child.children[0] = n
                    changed[0] = True
                    return child
                return n
            if isinstance(child, L.JoinNode) and child.mode in (
                    JoinMode.INNER, JoinMode.CROSS, JoinMode.SEMI,
                    *ANTI_MODES):
                lcols = _output_columns(child.children[0], catalog)
                rcols = _output_columns(child.children[1], catalog)
                if child.mode in EXISTENCE_MODES:
                    rcols = None  # only the probe side survives a semi/anti
                if lcols is not None and needed <= set(lcols):
                    child.children[0] = L.PredicateNode(n.predicate,
                                                        child.children[0])
                    changed[0] = True
                    return child
                if rcols is not None and needed <= set(rcols):
                    child.children[1] = L.PredicateNode(n.predicate,
                                                        child.children[1])
                    changed[0] = True
                    return child
            return n

        while changed[0]:
            changed[0] = False
            root = L.map_lqp(root, visit)
        return root


class SemiJoinPushdownRule:
    """Push SEMI/ANTI joins toward the relation that owns the probe key:
    Semi(Join(A,B), S) on a key from A  ->  Join(Semi(A,S), B). Also commutes
    with predicates on the probe side. (The reference reaches the same
    effect through its subquery-to-join rewriting order; our translator
    applies subquery joins last, so this rule restores early filtering.)"""

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        changed = [True]

        def visit(n: L.LQPNode) -> L.LQPNode:
            if not (isinstance(n, L.JoinNode)
                    and n.mode in EXISTENCE_MODES):
                return n
            probe, build = n.children
            key = n.left_col
            if isinstance(probe, L.PredicateNode):
                # commute below predicates ONLY to reach a join further down;
                # over a plain relation the predicate is the cheaper filter
                # and must run first (Q4/Q21: date filter before the semi)
                below = probe
                while isinstance(below, L.PredicateNode):
                    below = below.children[0]
                if not (isinstance(below, L.JoinNode) and below.mode in
                        (JoinMode.INNER, JoinMode.CROSS)):
                    return n
                n.children[0] = probe.children[0]
                probe.children[0] = n
                changed[0] = True
                return probe
            if isinstance(probe, L.JoinNode) and probe.mode in (
                    JoinMode.INNER, JoinMode.CROSS):
                lcols = _output_columns(probe.children[0], catalog)
                rcols = _output_columns(probe.children[1], catalog)
                if lcols is not None and key in lcols:
                    probe.children[0] = L.JoinNode(
                        n.mode, probe.children[0], build, key, n.right_col)
                    changed[0] = True
                    return probe
                if rcols is not None and key in rcols:
                    probe.children[1] = L.JoinNode(
                        n.mode, probe.children[1], build, key, n.right_col)
                    changed[0] = True
                    return probe
            return n

        while changed[0]:
            changed[0] = False
            root = L.map_lqp(root, visit)
        return root


class PredicateReorderingRule:
    """Sort consecutive predicates most-selective-first (reference:
    predicate_reordering_rule.cpp — descending selectivity toward the top,
    i.e. the cheapest filter runs first on the most rows)."""

    def __init__(self, stats: Optional[Dict[str, TableStatistics]] = None):
        self.stats = stats or {}

    def _table_stats(self, node: L.LQPNode) -> Optional[TableStatistics]:
        while node.children:
            node = node.children[0]
        if isinstance(node, L.StoredTableNode):
            ts = self.stats.get(node.table_name)
            if ts is not None:
                return ts
        if self.stats:  # column-name union across tables (unique prefixes)
            from hyrise_tpu_torch.plan.statistics import merge_statistics
            return merge_statistics(self.stats)
        return None

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        def visit(n: L.LQPNode) -> L.LQPNode:
            if not (isinstance(n, L.PredicateNode)
                    and isinstance(n.children[0], L.PredicateNode)):
                return n
            chain = [n]
            cur = n
            while isinstance(cur.children[0], L.PredicateNode):
                cur = cur.children[0]
                chain.append(cur)
            below = cur.children[0]
            ts = self._table_stats(below)
            sel = [(estimate_predicate_selectivity(ts, p.predicate), p)
                   for p in chain]
            # most selective (lowest selectivity) closest to the source
            sel.sort(key=lambda x: x[0], reverse=True)
            top = sel[0][1]
            for (_, a), (_, b) in zip(sel, sel[1:]):
                a.children[0] = b
            sel[-1][1].children[0] = below
            return top

        return L.map_lqp(root, visit)


class ColumnPruningRule:
    """Record required columns on StoredTableNodes so the translator can
    insert narrow projections at the leaves."""

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        if catalog is None:
            return root
        required: Dict[int, Set[str]] = {}

        def collect(n: L.LQPNode):
            # any column referenced anywhere in the plan is required
            cols: Set[str] = set()
            if isinstance(n, L.PredicateNode):
                cols |= set(n.predicate.columns())
            elif isinstance(n, L.ProjectionNode):
                for o in n.outputs:
                    if isinstance(o, str):
                        cols.add(o)
                    else:
                        cols |= set(o[1].columns())
            elif isinstance(n, L.AggregateNode):
                cols |= set(n.groupby)
                for _, a in n.aggregates:
                    if a.arg is not None:
                        cols |= set(a.arg.columns())
            elif isinstance(n, L.JoinNode):
                if n.left_col:
                    cols.add(n.left_col)
                if n.right_col:
                    cols.add(n.right_col)
            elif isinstance(n, L.SortNode):
                cols |= {c for c, _ in n.sort_defs}
            elif isinstance(n, L.AliasNode) and n.sources is not None:
                # a renaming alias requires nothing by itself: its outputs
                # are pulled only by consumers above (prunable below)
                if not isinstance(n.children[0], (L.StoredTableNode,
                                                  L.AddRowIdsNode)):
                    cols |= set(n.sources)
            elif isinstance(n, L.AliasNode) and n.sources is None:
                return None  # positional alias: needs all columns
            elif isinstance(n, (L.UnionNode, L.DifferenceNode, L.DistinctNode,
                                L.InsertNode, L.DeleteNode, L.UpdateNode)):
                return None  # conservative: all columns
            return cols

        all_required: Set[str] = set()
        conservative = [False]

        def walk(n: L.LQPNode):
            c = collect(n)
            if c is None:
                conservative[0] = True
            else:
                all_required.update(c)
            for ch in n.children:
                walk(ch)

        walk(root)
        # also keep the final output columns
        out = _output_columns(root, catalog)
        if out is not None:
            all_required.update(out)
        if conservative[0]:
            return root

        seen = set()

        def visit(n: L.LQPNode) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            # qualified-alias leaves (the SQL path): prune unreferenced
            # outputs from the alias AND the stored table beneath it.
            # Handled top-down so the bare-name branch below never fires on
            # an alias-wrapped leaf first.
            if isinstance(n, L.AliasNode) and n.sources is not None and \
                    isinstance(n.children[0], L.StoredTableNode):
                stored = n.children[0]
                if catalog.has_table(stored.table_name) and \
                        stored.pruned_columns is None:
                    kept = [(nm, src) for nm, src in zip(n.names, n.sources)
                            if nm in all_required]
                    if kept and len(kept) < len(n.names):
                        n.names = [nm for nm, _ in kept]
                        n.sources = [src for _, src in kept]
                        stored.pruned_columns = [src for _, src in kept]
                seen.add(id(stored))
                return
            if isinstance(n, L.AliasNode) and n.sources is not None and \
                    isinstance(n.children[0], L.AddRowIdsNode):
                # rid-tagging aliases (decorrelation) re-export the outer
                # columns; drop pairs nobody consumes so leaf pruning below
                # can't orphan a source name
                kept = [(nm, src) for nm, src in zip(n.names, n.sources)
                        if nm in all_required or src == "row_id"]
                if kept and len(kept) < len(n.names):
                    n.names = [nm for nm, _ in kept]
                    n.sources = [src for _, src in kept]
            if isinstance(n, L.StoredTableNode) and n.pruned_columns is None \
                    and catalog.has_table(n.table_name):
                cols = catalog.get_table(n.table_name).column_names
                keep = [c for c in cols if c in all_required]
                if keep and len(keep) < len(cols):
                    n.pruned_columns = keep
            for c in n.children:
                visit(c)

        visit(root)
        return root


def _stored_leaf(node: L.LQPNode, catalog):
    """(stored table node, table, name -> stored column) when `node` reads a
    catalog table directly: the StoredTableNode itself, or an AliasNode of
    it (the SQL translator's qualified names); else None."""
    alias = None
    if isinstance(node, L.AliasNode):
        alias, node = node, node.children[0]
    if not isinstance(node, L.StoredTableNode) or not catalog.has_table(node.table_name):
        return None
    table = catalog.get_table(node.table_name)
    columns = node.pruned_columns if node.pruned_columns is not None \
        else table.column_names
    if alias is None:
        names = {c: c for c in columns}
    else:
        names = dict(zip(alias.names, alias.sources if alias.sources is not None
                         else columns))
    return node, table, names


class IndexScanRule:
    """Mark a predicate over a stored table for index execution when the
    table has an index on the scanned column (reference:
    optimizer/strategy/index_scan_rule.cpp). The translator lowers a marked
    PredicateNode to ops/index_scan.IndexScan. Marks name the stored
    column: `use_index` = (column, cond, value, value2) and
    `use_index_composite` = (first column, value, [(column, value), ...]).
    Under MVCC no predicate is marked: a ValidateNode stands between every
    predicate and its stored table."""

    SUPPORTED = (PredicateCondition.EQUALS, PredicateCondition.LESS_THAN,
                 PredicateCondition.LESS_THAN_EQUALS,
                 PredicateCondition.GREATER_THAN,
                 PredicateCondition.GREATER_THAN_EQUALS,
                 PredicateCondition.BETWEEN)

    def apply(self, root: L.LQPNode, catalog) -> L.LQPNode:
        if catalog is None:
            return root
        seen = set()

        def visit(n: L.LQPNode) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, L.PredicateNode):
                leaf = _stored_leaf(n.children[0], catalog)
                if leaf is not None:
                    _, table, names = leaf
                    probe = self.index_predicate(n.predicate, names)
                    if probe is not None and probe[0] in table.indexes:
                        n.use_index = probe
                # a chain of equality predicates over one stored table,
                # covered by a composite index: the bottom predicate gets
                # the combined lookup, those above re-check (cheaply, over
                # the narrowed rows)
                self._try_composite(n, catalog)
            for c in n.children:
                visit(c)

        visit(root)
        return root

    def _try_composite(self, n: L.PredicateNode, catalog) -> None:
        from hyrise_tpu_torch.storage.index import find_composite_index
        chain = []
        cur = n
        while isinstance(cur, L.PredicateNode):
            chain.append(cur)
            cur = cur.children[0]
        leaf = _stored_leaf(cur, catalog)
        if leaf is None or len(chain) < 2:
            return
        _, table, names = leaf
        by_col = {}
        for node in chain:
            p = self.index_predicate(node.predicate, names)
            if p is None or p[1] is not PredicateCondition.EQUALS:
                return
            by_col[p[0]] = p[2]
        bottom_col = self.index_predicate(chain[-1].predicate, names)[0]
        for key in table.indexes:
            if not isinstance(key, tuple):
                continue
            covered = []
            for col in key:
                if col not in by_col:
                    break
                covered.append(col)
            # the bottom predicate is REPLACED by the IndexScan, so its own
            # column must be covered
            if len(covered) >= 2 and bottom_col in covered and \
                    find_composite_index(table, covered) is not None:
                chain[-1].use_index_composite = (
                    covered[0], by_col[covered[0]],
                    [(c, by_col[c]) for c in covered[1:]])
                return

    @classmethod
    def index_predicate(cls, e: ast.Expr, names=None):
        """(stored column, cond, value, value2) if `e` compares one column
        with literals in a way an index serves, else None. `names` maps the
        predicate's column names to stored columns (None: the same)."""
        def stored(ref):
            return ref.name if names is None else names.get(ref.name)

        if isinstance(e, ast.Between) and isinstance(e.value, ast.ColumnRef) and \
                isinstance(e.lower, ast.Literal) and isinstance(e.upper, ast.Literal):
            column = stored(e.value)
            return None if column is None else \
                (column, PredicateCondition.BETWEEN, e.lower.value, e.upper.value)
        if not isinstance(e, ast.Comparison) or e.cond not in cls.SUPPORTED:
            return None
        if isinstance(e.left, ast.ColumnRef) and isinstance(e.right, ast.Literal):
            column, cond, value = stored(e.left), e.cond, e.right.value
        elif isinstance(e.right, ast.ColumnRef) and isinstance(e.left, ast.Literal):
            column, cond, value = stored(e.right), e.cond.flipped(), e.left.value
        else:
            return None
        return None if column is None or value is None else (column, cond, value, None)


class Optimizer:
    """Reference: optimizer.cpp:83-144 rule-batch loop."""

    def __init__(self, stats: Optional[Dict[str, TableStatistics]] = None):
        self.stats = stats or {}

    def optimize(self, root: L.LQPNode, catalog=None) -> L.LQPNode:
        root = ConstantCalculationRule().apply(root, catalog)
        root = DisjunctionInferenceRule().apply(root, catalog)
        for _ in range(100):  # iterative batch
            before = root.describe()
            root = JoinDetectionRule(self.stats).apply(root, catalog)
            root = PredicatePushdownRule().apply(root, catalog)
            root = SemiJoinPushdownRule().apply(root, catalog)
            root = PredicateReorderingRule(self.stats).apply(root, catalog)
            if root.describe() == before:
                break
        from hyrise_tpu_torch.plan.join_ordering import JoinOrderingRule
        root = JoinOrderingRule(self.stats).apply(root, catalog)
        root = PredicatePushdownRule().apply(root, catalog)
        root = ColumnPruningRule().apply(root, catalog)
        root = IndexScanRule().apply(root, catalog)
        return root

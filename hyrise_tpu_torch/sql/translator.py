"""SQL parse tree -> LQP.

Copy of hyrise_tpu/sql/translator.py, DML and CREATE TABLE included.

Role of the reference's SQLTranslator (src/lib/sql/sql_translator.cpp, 1292
LoC): identifier resolution with scopes, FROM/JOIN trees, WHERE/HAVING,
aggregates, subselects.

Column identity strategy: every base-table column is renamed to the
qualified name "alias.column" at the leaves (AliasNode), so self-joins and
duplicate names are always unambiguous; the final projection restores
display names. (The reference achieves the same with LQPColumnReference
node+id pairs.)

Subquery handling (the reference creates PQPSelectExpressions; we
decorrelate at translation time, SURVEY.md §7):
- [NOT] EXISTS (corr. equality)        -> SEMI/ANTI join
- x [NOT] IN (SELECT ...)              -> SEMI/ANTI join
- uncorrelated scalar subquery         -> ScalarSubquery placeholder,
                                          resolved by the pipeline before
                                          physical execution
- correlated scalar aggregate          -> group-by on the correlation key +
  (SELECT agg(e) FROM t WHERE t.k=o.k)    join back + column comparison
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.plan import lqp as L
from hyrise_tpu_torch.sql import parser as P
from hyrise_tpu_torch.types import (AggregateFunction, DataType, JoinMode,
                              PredicateCondition, SortMode)


class SQLTranslationError(Exception):
    pass


@dataclasses.dataclass
class ScalarSubquery(ast.Expr):
    """Placeholder literal: an uncorrelated scalar subquery's LQP. The SQL
    pipeline executes it and substitutes a Literal before physical
    translation."""

    lqp: L.LQPNode

    def children(self):
        return ()

    def __repr__(self):
        return "ScalarSubquery(...)"


_uniq = itertools.count()


def _gen_name(prefix: str) -> str:
    return f"__{prefix}_{next(_uniq)}__"


class Scope:
    """FROM-clause scope: alias -> list of (qualified_name, bare_name)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.tables: Dict[str, List[Tuple[str, str]]] = {}
        self.parent = parent

    def add_table(self, alias: str, bare_columns: Sequence[str]):
        if alias in self.tables:
            raise SQLTranslationError(f"duplicate table alias {alias!r}")
        self.tables[alias] = [(f"{alias}.{c}", c) for c in bare_columns]

    def resolve(self, table: Optional[str], name: str,
                _local_only: bool = False) -> str:
        if table is not None:
            if table in self.tables:
                for q, b in self.tables[table]:
                    if b == name:
                        return q
                raise SQLTranslationError(
                    f"column {name!r} not found in table {table!r}")
            if self.parent is not None and not _local_only:
                return self.parent.resolve(table, name)
            raise SQLTranslationError(f"unknown table alias {table!r}")
        hits = []
        for alias, cols in self.tables.items():
            for q, b in cols:
                if b == name:
                    hits.append(q)
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SQLTranslationError(f"ambiguous column {name!r}: {hits}")
        if self.parent is not None and not _local_only:
            return self.parent.resolve(table, name)
        raise SQLTranslationError(f"unknown column {name!r}")

    def is_local(self, table: Optional[str], name: str) -> bool:
        try:
            self.resolve(table, name, _local_only=True)
            return True
        except SQLTranslationError:
            return False

    def all_columns(self) -> List[Tuple[str, str]]:
        out = []
        for alias, cols in self.tables.items():
            out.extend(cols)
        return out


_AGG_FUNCS = {
    "sum": AggregateFunction.SUM, "min": AggregateFunction.MIN,
    "max": AggregateFunction.MAX, "avg": AggregateFunction.AVG,
    "count": AggregateFunction.COUNT,
}

_TYPE_NAMES = {
    "int": DataType.INT32, "integer": DataType.INT32,
    "long": DataType.INT64, "bigint": DataType.INT64,
    "float": DataType.FLOAT32, "real": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "text": DataType.STRING, "string": DataType.STRING,
    "varchar": DataType.STRING,
}


class SQLToLQPTranslator:
    def __init__(self, catalog=None, params: Optional[List[object]] = None):
        self.catalog = catalog
        self.params = params

    # -- public --------------------------------------------------------------

    def translate(self, stmt) -> L.LQPNode:
        if isinstance(stmt, P.SelectStmt):
            node, _ = self._select(stmt, Scope())
            return node
        if isinstance(stmt, P.SetOpStmt):
            return self._set_op(stmt)
        if isinstance(stmt, P.InsertStmt):
            return self._insert(stmt)
        if isinstance(stmt, P.DeleteStmt):
            return self._delete(stmt)
        if isinstance(stmt, P.UpdateStmt):
            return self._update(stmt)
        if isinstance(stmt, P.CreateViewStmt):
            inner, _ = self._select(stmt.select, Scope())
            return L.CreateViewNode(stmt.name, inner)
        if isinstance(stmt, P.DropViewStmt):
            return L.DropViewNode(stmt.name)
        if isinstance(stmt, P.CreateTableStmt):
            from hyrise_tpu_torch.storage.table import TableColumnDefinition
            defs = []
            for name, type_name, nullable in stmt.columns:
                if type_name not in _TYPE_NAMES:
                    raise SQLTranslationError(f"unknown type {type_name!r}")
                defs.append(TableColumnDefinition(name, _TYPE_NAMES[type_name],
                                                  nullable))
            return L.CreateTableNode(stmt.name, defs)
        if isinstance(stmt, P.DropTableStmt):
            return L.DropTableNode(stmt.name)
        if isinstance(stmt, P.ShowStmt):
            return (L.ShowTablesNode() if stmt.what == "tables"
                    else L.ShowColumnsNode(stmt.table))
        raise SQLTranslationError(f"cannot translate {type(stmt).__name__}")

    # -- DML -------------------------------------------------------------------

    def _insert(self, stmt: P.InsertStmt) -> L.LQPNode:
        target = self.catalog.get_table(stmt.table)
        if stmt.select is not None:
            values_node, _ = self._select(stmt.select, Scope())
            return L.InsertNode(stmt.table, values_node)
        # literal VALUES -> a static table of the target's schema; columns the
        # statement leaves out are NULL
        import numpy as np
        from hyrise_tpu_torch.storage.column import Column
        from hyrise_tpu_torch.storage.table import Table

        col_order = stmt.columns or target.column_names
        rows = stmt.values
        given = {}
        for j, cname in enumerate(col_order):
            vals = []
            for row in rows:
                cell = row[j]
                if isinstance(cell, P.ELiteral):
                    vals.append(cell.value)
                elif isinstance(cell, P.EUnary) and cell.op == "-" and \
                        isinstance(cell.value, P.ELiteral):
                    vals.append(-cell.value.value)
                else:
                    raise SQLTranslationError("INSERT VALUES must be literals")
            given[cname] = vals
        n = len(rows)
        cols = []
        for c in target.columns:
            if c.name in given:
                vals = given[c.name]
                valid = np.array([v is not None for v in vals], dtype=bool)
                validity = None if valid.all() else valid
                if c.dtype is DataType.STRING:
                    data = np.array(vals, dtype=object)
                else:
                    data = np.array([0 if v is None else v for v in vals],
                                    dtype=c.dtype.numpy_dtype)
            else:
                validity = np.zeros(n, dtype=bool)
                data = (np.array([""] * n, dtype=object) if c.dtype is DataType.STRING
                        else np.zeros(n, dtype=c.dtype.numpy_dtype))
            cols.append(Column.from_numpy(c.name, c.dtype, data, validity,
                                          device=target.device))
        return L.InsertNode(stmt.table, L.StaticTableNode(Table(cols, n, name="values")))

    def _rows_to_change(self, table: str, where) -> Tuple[L.LQPNode, Scope, List[str]]:
        """Validate over the table's rows with their `row_id`, filtered by
        WHERE: the rows a DELETE or UPDATE changes."""
        scope = Scope()
        cols = self.catalog.get_table(table).column_names
        scope.add_table(table, cols)
        base = L.AliasNode([f"{table}.{c}" for c in cols] + ["row_id"],
                           L.AddRowIdsNode(L.StoredTableNode(table)),
                           sources=cols + ["row_id"])
        node = L.ValidateNode(base)
        if where is not None:
            node = self._where(where, node, scope)
        return node, scope, cols

    def _delete(self, stmt: P.DeleteStmt) -> L.LQPNode:
        node, _, _ = self._rows_to_change(stmt.table, stmt.where)
        return L.DeleteNode(stmt.table, node)

    def _update(self, stmt: P.UpdateStmt) -> L.LQPNode:
        node, scope, cols = self._rows_to_change(stmt.table, stmt.where)
        assigned = {cname: self._expr(e, scope) for cname, e in stmt.assignments}
        outputs = [(c, assigned[c] if c in assigned
                    else ast.col(scope.resolve(None, c))) for c in cols]
        return L.UpdateNode(stmt.table, node, L.ProjectionNode(outputs, node))

    def _select_any(self, stmt, scope: Scope
                    ) -> Tuple[L.LQPNode, List[str]]:
        """(node, output names) for a plain SelectStmt OR a compound
        SetOpStmt — subquery positions accept both."""
        if isinstance(stmt, P.SetOpStmt):
            node, names = self._set_op_named(stmt)
            return node, names
        return self._select(stmt, scope)

    def _set_op(self, stmt: P.SetOpStmt) -> L.LQPNode:
        return self._set_op_named(stmt)[0]

    def _set_op_named(self, stmt: P.SetOpStmt
                      ) -> Tuple[L.LQPNode, List[str]]:
        def side(s):
            if isinstance(s, P.SetOpStmt):
                return self._set_op_named(s)
            node, names = self._select(s, Scope())
            return node, names

        left, l_names = side(stmt.left)
        right, _ = side(stmt.right)
        if stmt.op == "union_all":
            node: L.LQPNode = L.UnionNode("all", left, right)
        elif stmt.op == "union":
            node = L.UnionNode("positions", left, right)
        elif stmt.op == "except":
            node = L.DistinctNode(L.DifferenceNode(left, right))
        elif stmt.op == "intersect":
            # A INTERSECT B == distinct(A) \ (distinct(A) \ B)
            da = L.DistinctNode(left)
            node = L.DifferenceNode(da, L.DifferenceNode(da, right))
        else:
            raise SQLTranslationError(f"unknown set op {stmt.op}")
        if stmt.orderby and l_names:
            defs = []
            for e, d in stmt.orderby:
                if isinstance(e, P.EColumn) and e.name in l_names:
                    from hyrise_tpu_torch.types import SortMode as SM
                    defs.append((e.name, SM.ASCENDING if d == "asc"
                                 else SM.DESCENDING))
                else:
                    raise SQLTranslationError(
                        "compound ORDER BY must use output column names")
            node = L.SortNode(defs, node)
        if stmt.limit is not None:
            node = L.LimitNode(stmt.limit, node)
        return node, (l_names or [])

    # -- SELECT --------------------------------------------------------------

    def _select(self, sel: P.SelectStmt, outer: Scope
                ) -> Tuple[L.LQPNode, List[str]]:
        scope = Scope(outer)
        node = self._from_clause(sel, scope)

        if sel.where is not None:
            node = self._where(sel.where, node, scope)

        has_agg = any(self._contains_agg(e) for _, e in sel.select
                      if e != "*") or sel.groupby or \
            (sel.having is not None)

        if has_agg:
            node, out_names = self._aggregate_select(sel, node, scope)
        else:
            node, out_names = self._plain_select(sel, node, scope)

        if sel.distinct:
            node = L.DistinctNode(node)

        if sel.orderby:
            defs = []
            hidden = False
            for e, d in sel.orderby:
                name = self._resolve_output_ref(e, sel, out_names, scope)
                if name not in out_names and not has_agg:
                    # ORDER BY a column dropped by the projection: re-add it
                    # as a hidden output column, sort, then project it away.
                    if isinstance(node, L.ProjectionNode):
                        q = scope.resolve(e.table, e.name) \
                            if isinstance(e, P.EColumn) else name
                        node.outputs.append((name, self._expr(e, scope)))
                        hidden = True
                mode = SortMode.ASCENDING if d == "asc" else SortMode.DESCENDING
                defs.append((name, mode))
            node = L.SortNode(defs, node)
            if hidden:
                node = L.ProjectionNode(list(out_names), node)

        if sel.limit is not None:
            node = L.LimitNode(sel.limit, node)
        return node, out_names

    def _resolve_output_ref(self, e, sel, out_names: List[str],
                            scope: Scope) -> str:
        # ORDER BY: positional, select alias, or column name
        if isinstance(e, P.ELiteral) and isinstance(e.value, int):
            return out_names[e.value - 1]
        if isinstance(e, P.EColumn) and e.table is None and e.name in out_names:
            return e.name
        # structural match against select expressions
        for (alias, se), name in zip(
                [(a, x) for a, x in sel.select if x != "*"], out_names):
            if repr(se) == repr(e):
                return name
        if isinstance(e, P.EColumn):
            return e.name  # bare column that survived into the output
        raise SQLTranslationError(f"cannot resolve ORDER BY expression {e}")

    # -- FROM ----------------------------------------------------------------

    def _table_ref_node(self, ref: P.TableRef, scope: Scope) -> L.LQPNode:
        alias = ref.alias or ref.name
        if ref.subquery is not None:
            if alias is None:
                alias = _gen_name("sub")
            sub_node, sub_cols = self._select_any(ref.subquery, Scope())
            scope.add_table(alias, sub_cols)
            return L.AliasNode([f"{alias}.{c}" for c in sub_cols], sub_node,
                               sources=sub_cols)
        name = ref.name
        cat = self.catalog
        if cat is not None and cat.has_view(name):
            view_lqp = cat.get_view(name)
            from hyrise_tpu_torch.plan.optimizer import _output_columns
            cols = _output_columns(view_lqp, cat)
            if cols is None:
                raise SQLTranslationError(
                    f"cannot determine columns of view {name!r}")
            scope.add_table(alias, cols)
            return L.AliasNode([f"{alias}.{c}" for c in cols], view_lqp,
                               sources=cols)
        if cat is None or not cat.has_table(name):
            raise SQLTranslationError(f"unknown table {name!r}")
        cols = cat.get_table(name).column_names
        scope.add_table(alias, cols)
        return L.AliasNode([f"{alias}.{c}" for c in cols],
                           L.StoredTableNode(name), sources=cols)

    def _from_clause(self, sel: P.SelectStmt, scope: Scope) -> L.LQPNode:
        if not sel.from_refs:
            # SELECT without FROM: single-row dummy table
            from hyrise_tpu_torch.storage.table import Table, TableColumnDefinition
            import numpy as np
            t = Table.from_arrays(
                "dummy", [TableColumnDefinition("", DataType.INT32)],
                [np.array([0], dtype=np.int32)],
                device="cpu" if self.catalog is None else self.catalog.device)
            return L.StaticTableNode(t)
        node = self._table_ref_node(sel.from_refs[0], scope)
        for ref in sel.from_refs[1:]:
            right = self._table_ref_node(ref, scope)
            node = L.JoinNode(JoinMode.CROSS, node, right)
        for jc in sel.joins:
            right = self._table_ref_node(jc.ref, scope)
            node = self._apply_join(node, right, jc, scope)
        return node

    def _apply_join(self, left: L.LQPNode, right: L.LQPNode,
                    jc: P.JoinClause, scope: Scope) -> L.LQPNode:
        mode = {"inner": JoinMode.INNER, "left": JoinMode.LEFT,
                "right": JoinMode.RIGHT, "full": JoinMode.OUTER,
                "cross": JoinMode.CROSS}[jc.kind]
        if mode is JoinMode.CROSS or jc.on is None:
            return L.JoinNode(JoinMode.CROSS, left, right)
        # split ON into conjuncts; find one equi pair, classify the rest
        conjuncts = self._split_and(jc.on)
        equi: Optional[Tuple[str, str, PredicateCondition]] = None
        residual: List[P.EBinary] = []
        right_cols = {q for q, b in self._node_columns(right, scope)}
        for c in conjuncts:
            if equi is None and isinstance(c, P.EBinary) and c.op == "=" and \
                    isinstance(c.left, P.EColumn) and \
                    isinstance(c.right, P.EColumn):
                lq = scope.resolve(c.left.table, c.left.name)
                rq = scope.resolve(c.right.table, c.right.name)
                if rq in right_cols and lq not in right_cols:
                    equi = (lq, rq, PredicateCondition.EQUALS)
                    continue
                if lq in right_cols and rq not in right_cols:
                    equi = (rq, lq, PredicateCondition.EQUALS)
                    continue
            residual.append(c)
        if equi is None:
            if mode is JoinMode.INNER:
                node = L.JoinNode(JoinMode.CROSS, left, right)
                for c in conjuncts:
                    node = L.PredicateNode(self._expr(c, scope), node)
                return node
            raise SQLTranslationError("outer join requires an equi condition")
        if residual:
            if mode is JoinMode.INNER:
                node = L.JoinNode(mode, left, right, equi[0], equi[1])
                for c in residual:
                    node = L.PredicateNode(self._expr(c, scope), node)
                return node
            # outer join: residual must reference only the right side -> it
            # pre-filters the right input (the Q13 pattern)
            for c in residual:
                cols = {scope.resolve(e.table, e.name)
                        for e in self._collect_columns(c)}
                if not cols <= right_cols:
                    raise SQLTranslationError(
                        "outer-join residual condition must reference only "
                        "the inner side")
                right = L.PredicateNode(self._expr(c, scope), right)
        return L.JoinNode(mode, left, right, equi[0], equi[1])

    def _node_columns(self, node: L.LQPNode, scope: Scope
                      ) -> List[Tuple[str, str]]:
        from hyrise_tpu_torch.plan.optimizer import _output_columns
        cols = _output_columns(node, self.catalog)
        if cols is None:
            return []
        return [(c, c.split(".", 1)[1] if "." in c else c) for c in cols]

    # -- WHERE (incl. subquery rewrites) -------------------------------------

    def _split_and(self, e) -> List[object]:
        if isinstance(e, P.EBinary) and e.op == "and":
            return self._split_and(e.left) + self._split_and(e.right)
        return [e]

    def _where(self, where, node: L.LQPNode, scope: Scope) -> L.LQPNode:
        # Plain conjuncts first, subquery rewrites (semi/anti joins) last, so
        # join-detection sees Predicate-over-CrossJoin patterns unobstructed.
        conjuncts = self._split_and(where)

        def is_subquery_conjunct(c):
            if isinstance(c, P.EExists):
                return True
            if isinstance(c, P.EIn) and c.subquery is not None:
                return True
            if isinstance(c, P.EBinary) and (
                    isinstance(c.left, P.ESubquery)
                    or isinstance(c.right, P.ESubquery)):
                return True
            return False

        for c in conjuncts:
            if not is_subquery_conjunct(c):
                node = self._apply_conjunct(c, node, scope)
        for c in conjuncts:
            if is_subquery_conjunct(c):
                node = self._apply_conjunct(c, node, scope)
        return node

    def _apply_conjunct(self, c, node: L.LQPNode, scope: Scope) -> L.LQPNode:
        if isinstance(c, P.EExists):
            return self._exists_to_join(c.subquery, c.negate, node, scope)
        if isinstance(c, P.EIn) and c.subquery is not None:
            return self._in_subquery_to_join(c, node, scope)
        # comparison against a correlated scalar aggregate?
        if isinstance(c, P.EBinary) and c.op in ("=", "<>", "<", "<=", ">",
                                                 ">="):
            for side, other in ((c.left, c.right), (c.right, c.left)):
                if isinstance(side, P.ESubquery):
                    rewritten = self._scalar_subquery_compare(
                        c, side, other, side is c.right, node, scope)
                    if rewritten is not None:
                        return rewritten
        return L.PredicateNode(self._expr(c, scope), node)

    def _exists_count_pred(self, sub_node: L.LQPNode, negate: bool,
                           node: L.LQPNode) -> L.LQPNode:
        """Uncorrelated [NOT] EXISTS: COUNT(*) over the subquery compared
        against 0 (the scalar-subquery placeholder machinery executes it
        once before physical translation)."""
        name = _gen_name("exists_cnt")
        agg = L.AggregateNode([], [(name, ast.count_())], sub_node)
        cond = (PredicateCondition.EQUALS if negate
                else PredicateCondition.GREATER_THAN)
        pred = ast.Comparison(cond, ScalarSubquery(agg), ast.lit(0))
        return L.PredicateNode(pred, node)

    def _exists_to_join(self, sub: P.SelectStmt, negate: bool,
                        node: L.LQPNode, scope: Scope) -> L.LQPNode:
        """[NOT] EXISTS with equality correlation -> SEMI/ANTI join.

        Conjuncts referencing BOTH scopes with non-equality conditions
        (e.g. Q21's l2.l_suppkey <> l1.l_suppkey) use the general row-id
        decorrelation: tag outer rows with row ids, inner-join on the
        equality correlation, filter the residual conditions on the joined
        scope, take the distinct matched row ids, and semi/anti join the
        outer rows against them.
        """
        if isinstance(sub, P.SetOpStmt):
            # compound subquery: can't correlate; nonempty test
            return self._exists_count_pred(self._set_op(sub), negate, node)
        sub_scope = Scope(scope)
        sub_node = self._from_clause(sub, sub_scope)
        corr: List[Tuple[str, str]] = []  # (outer_qualified, inner_qualified)
        residual = []                     # conjuncts mixing both scopes
        if sub.where is not None:
            for c in self._split_and(sub.where):
                pair = self._correlation_pair(c, sub_scope, scope)
                if pair is not None:
                    corr.append(pair)
                    continue
                cols = self._collect_columns(c)
                locals_only = all(sub_scope.is_local(e.table, e.name)
                                  for e in cols)
                if locals_only:
                    sub_node = self._apply_conjunct(c, sub_node, sub_scope)
                else:
                    residual.append(c)
        if not corr and not residual:
            # fully uncorrelated EXISTS: true iff the subquery is nonempty
            return self._exists_count_pred(sub_node, negate, node)
        if corr and not residual:
            outer_col, inner_col = self._single_corr(corr, sub_node, sub_scope)
            mode = JoinMode.ANTI if negate else JoinMode.SEMI
            return L.JoinNode(mode, node, sub_node, outer_col, inner_col)

        # general row-id decorrelation
        rid = _gen_name("rid")
        from hyrise_tpu_torch.plan.optimizer import _output_columns
        outer_cols = _output_columns(node, self.catalog)
        if outer_cols is None:
            raise SQLTranslationError(
                "cannot determine outer columns for EXISTS decorrelation")
        tagged = L.AliasNode(outer_cols + [rid], L.AddRowIdsNode(node),
                             sources=outer_cols + ["row_id"])
        if corr:
            outer_col, inner_col = self._single_corr(corr, sub_node,
                                                     sub_scope)
            joined = L.JoinNode(JoinMode.INNER, tagged, sub_node, outer_col,
                                inner_col)
        else:
            # correlation only through non-equality residuals (quantified
            # comparisons): pair every outer row with every subquery row
            joined = L.JoinNode(JoinMode.CROSS, tagged, sub_node)
        for c in residual:
            # resolve against sub_scope (falls back to outer scope through
            # the parent chain); all columns exist in the joined output
            joined = L.PredicateNode(self._expr(c, sub_scope), joined)
        matched = L.AggregateNode([rid], [], joined)  # distinct row ids
        m_rid = _gen_name("mrid")
        matched = L.AliasNode([m_rid], matched, sources=[rid])
        mode = JoinMode.ANTI if negate else JoinMode.SEMI
        semi = L.JoinNode(mode, tagged, matched, rid, m_rid)
        # drop the row-id helper column
        return L.AliasNode(outer_cols, semi, sources=outer_cols)

    def _in_subquery_to_join(self, c: P.EIn, node: L.LQPNode,
                             scope: Scope) -> L.LQPNode:
        if not isinstance(c.value, P.EColumn):
            raise SQLTranslationError("IN (SELECT ...) requires a column lhs")
        outer_col = scope.resolve(c.value.table, c.value.name)
        sub_node, sub_cols = self._select_any(c.subquery, scope)
        if len(sub_cols) != 1:
            raise SQLTranslationError("IN subquery must return one column")
        # NOT IN carries three-valued NULL semantics (NULL probe key or a
        # NULL in the subquery result rejects the row): the reference's
        # JoinMode::AntiNullAsTrue (types.hpp), distinct from NOT EXISTS
        mode = JoinMode.ANTI_NULL_AS_TRUE if c.negate else JoinMode.SEMI
        return L.JoinNode(mode, node, sub_node, outer_col, sub_cols[0])

    def _correlation_pair(self, c, sub_scope: Scope, outer_scope: Scope
                          ) -> Optional[Tuple[str, str]]:
        """c is `inner.col = outer.col` (either order) -> (outer_q, inner_q)."""
        if not (isinstance(c, P.EBinary) and c.op == "="
                and isinstance(c.left, P.EColumn)
                and isinstance(c.right, P.EColumn)):
            return None
        l_local = sub_scope.is_local(c.left.table, c.left.name)
        r_local = sub_scope.is_local(c.right.table, c.right.name)
        if l_local and not r_local:
            try:
                return (outer_scope.resolve(c.right.table, c.right.name),
                        sub_scope.resolve(c.left.table, c.left.name,
                                          _local_only=True))
            except SQLTranslationError:
                return None
        if r_local and not l_local:
            try:
                return (outer_scope.resolve(c.left.table, c.left.name),
                        sub_scope.resolve(c.right.table, c.right.name,
                                          _local_only=True))
            except SQLTranslationError:
                return None
        return None

    def _single_corr(self, corr: List[Tuple[str, str]], sub_node: L.LQPNode,
                     sub_scope: Scope) -> Tuple[str, str]:
        if len(corr) == 1:
            return corr[0]
        raise SQLTranslationError(
            "multi-column correlation not yet supported in SQL path")

    def _correlated_scalar_value(self, sub, node: L.LQPNode, scope: Scope):
        """Decorrelate `(SELECT agg(e) FROM t WHERE t.k = outer.k [AND ...])`
        against `node`: group the subquery by its correlation key, LEFT-join
        the per-key aggregates onto the outer rows, and return the value as
        a column expression (correlated COUNT over an empty group coalesces
        to 0 — reference parity with SQL semantics).

        Returns ("ok", (joined_node, value_expr)),
        ("uncorrelated", None) when there is no equality correlation, or
        ("unsupported", None) when correlated but not a lowerable aggregate.
        Shared by WHERE comparisons (_scalar_subquery_compare) and
        select-list scalar subqueries (_plain_select)."""
        if not isinstance(sub, P.SelectStmt) or len(sub.select) != 1 \
                or sub.select[0][1] == "*":
            return "uncorrelated", None
        sub_scope = Scope(scope)
        sub_from = self._from_clause(sub, sub_scope)
        corr: List[Tuple[str, str]] = []
        local_node = sub_from
        if sub.where is not None:
            for cc in self._split_and(sub.where):
                pair = self._correlation_pair(cc, sub_scope, scope)
                if pair is not None:
                    corr.append(pair)
                    continue
                cols = self._collect_columns(cc)
                if all(sub_scope.is_local(e.table, e.name) for e in cols):
                    local_node = self._apply_conjunct(cc, local_node,
                                                      sub_scope)
                else:
                    return "unsupported", None  # non-equality correlation
        if not corr:
            return "uncorrelated", None
        sel_expr = sub.select[0][1]
        if not self._contains_agg(sel_expr):
            return "unsupported", None
        inner_keys = [ic for _, ic in corr]
        aggs: List[Tuple[str, ast.AggregateExpr]] = []
        name_of: Dict[str, str] = {}

        def lower(e) -> ast.Expr:
            if isinstance(e, P.EFunc) and e.name in _AGG_FUNCS:
                r = repr(e)
                if r not in name_of:
                    name_of[r] = _gen_name("corr_agg")
                    aggs.append((name_of[r], self._agg_expr(e, sub_scope)))
                return ast.col(name_of[r])
            return self._expr_generic(e, lower, scope=sub_scope)

        value_expr = lower(sel_expr)
        agg_name = _gen_name("corr_val")
        agg_node = L.AggregateNode(inner_keys, aggs, local_node)
        agg_node = L.ProjectionNode(
            list(inner_keys) + [(agg_name, value_expr)], agg_node)
        # rename inner keys to avoid clashing with outer columns
        renamed = [_gen_name("ck") for _ in inner_keys]
        out_cols = inner_keys + [agg_name]
        agg_node = L.AliasNode(renamed + [agg_name], agg_node,
                               sources=out_cols)
        # LEFT join: outer rows with an empty correlated group survive with
        # NULL aggregates (COUNT coalesces to 0 below; any other aggregate
        # compares as NULL -> filtered, matching SQL)
        joined = L.JoinNode(JoinMode.LEFT, node, agg_node, corr[0][0],
                            renamed[0])
        for (outer_c, _), rn in list(zip(corr, renamed))[1:]:
            joined = L.PredicateNode(
                ast.Comparison(PredicateCondition.EQUALS, ast.col(outer_c),
                               ast.col(rn)), joined)
        value_ref: ast.Expr = ast.col(agg_name)
        if isinstance(sel_expr, P.EFunc) and sel_expr.name == "count":
            # a correlated COUNT over an EMPTY group is 0, not absent
            value_ref = ast.Case([(ast.IsNull(value_ref), ast.lit(0))],
                                 value_ref)
        return "ok", (joined, value_ref)

    def _rid_scalar_value(self, sub: P.SelectStmt, node: L.LQPNode,
                          scope: Scope):
        """Scalar aggregate subquery with ARBITRARY correlation (e.g.
        `m2.a < outer.a`): tag outer rows with row ids, cross-join the
        subquery's FROM, filter every WHERE conjunct in the joined scope
        (outer refs resolve through the scope chain), aggregate per outer
        row id, LEFT-join the values back. O(outer x inner) pairs — the
        general fallback when key-based decorrelation
        (_correlated_scalar_value) does not apply."""
        if len(sub.select) != 1 or sub.select[0][1] == "*":
            return None
        sel_expr = sub.select[0][1]
        if not self._contains_agg(sel_expr):
            return None
        from hyrise_tpu_torch.plan.optimizer import _output_columns
        outer_cols = _output_columns(node, self.catalog)
        if outer_cols is None:
            return None
        rid = _gen_name("rid")
        tagged = L.AliasNode(outer_cols + [rid], L.AddRowIdsNode(node),
                             sources=outer_cols + ["row_id"])
        sub_scope = Scope(scope)
        sub_from = self._from_clause(sub, sub_scope)
        joined = L.JoinNode(JoinMode.CROSS, tagged, sub_from)
        if sub.where is not None:
            for cc in self._split_and(sub.where):
                joined = L.PredicateNode(self._expr(cc, sub_scope), joined)
        aggs: List[Tuple[str, ast.AggregateExpr]] = []
        name_of: Dict[str, str] = {}

        def lower(e) -> ast.Expr:
            if isinstance(e, P.EFunc) and e.name in _AGG_FUNCS:
                r = repr(e)
                if r not in name_of:
                    name_of[r] = _gen_name("corr_agg")
                    aggs.append((name_of[r], self._agg_expr(e, sub_scope)))
                return ast.col(name_of[r])
            return self._expr_generic(e, lower, scope=sub_scope)

        value_expr = lower(sel_expr)
        agg_name = _gen_name("corr_val")
        agg_node = L.AggregateNode([rid], aggs, joined)
        agg_node = L.ProjectionNode([rid, (agg_name, value_expr)], agg_node)
        crid = _gen_name("crid")
        agg_node = L.AliasNode([crid, agg_name], agg_node,
                               sources=[rid, agg_name])
        back = L.JoinNode(JoinMode.LEFT, tagged, agg_node, rid, crid)
        value_ref: ast.Expr = ast.col(agg_name)
        if isinstance(sel_expr, P.EFunc) and sel_expr.name == "count":
            value_ref = ast.Case([(ast.IsNull(value_ref), ast.lit(0))],
                                 value_ref)
        return back, value_ref

    def _scalar_subquery_compare(self, c, sub_expr: P.ESubquery, other,
                                 sub_on_right: bool, node: L.LQPNode,
                                 scope: Scope) -> Optional[L.LQPNode]:
        """outer_expr OP (SELECT agg(e) FROM t WHERE corr) handling."""
        sub = sub_expr.subquery
        status, payload = self._correlated_scalar_value(sub, node, scope)
        if status == "unsupported":
            payload = (self._rid_scalar_value(sub, node, scope)
                       if isinstance(sub, P.SelectStmt) else None)
            if payload is None:
                return None
            status = "ok"
        if status == "uncorrelated":
            if isinstance(sub, P.SelectStmt) and (
                    len(sub.select) != 1 or sub.select[0][1] == "*"):
                return None
            sub_lqp, _ = self._select_any(sub, scope)
            joined: L.LQPNode = node
            value_ref: ast.Expr = ScalarSubquery(sub_lqp)
        else:
            joined, value_ref = payload
        cond = _COND_MAP[c.op]
        outer_e = self._expr(other, scope)
        if sub_on_right:
            pred = ast.Comparison(cond, outer_e, value_ref)
        else:
            pred = ast.Comparison(cond, value_ref, outer_e)
        return L.PredicateNode(pred, joined)

    # -- SELECT list / aggregation -------------------------------------------
    def _contains_agg(self, e) -> bool:
        if isinstance(e, (P.ESubquery, P.EExists)):
            return False  # subquery aggregates belong to the subquery
        if isinstance(e, P.EIn) and e.subquery is not None:
            return self._contains_agg(e.value)
        if isinstance(e, P.EFunc) and e.name in _AGG_FUNCS:
            return True
        for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
            v = getattr(e, f.name)
            if dataclasses.is_dataclass(v) and self._contains_agg(v):
                return True
            if isinstance(v, list):
                for item in v:
                    if isinstance(item, tuple):
                        if any(dataclasses.is_dataclass(x)
                               and self._contains_agg(x) for x in item):
                            return True
                    elif dataclasses.is_dataclass(item) and \
                            self._contains_agg(item):
                        return True
        return False

    def _collect_columns(self, e) -> List[P.EColumn]:
        out = []

        def walk(x):
            if isinstance(x, P.EColumn):
                out.append(x)
                return
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                for f in dataclasses.fields(x):
                    v = getattr(x, f.name)
                    if isinstance(v, list):
                        for item in v:
                            if isinstance(item, tuple):
                                for y in item:
                                    walk(y)
                            else:
                                walk(item)
                    else:
                        walk(v)

        walk(e)
        return out

    def _agg_expr(self, e: P.EFunc, scope: Scope) -> ast.AggregateExpr:
        fn = _AGG_FUNCS[e.name]
        if e.star:
            return ast.AggregateExpr(AggregateFunction.COUNT, None)
        if e.distinct:
            assert fn is AggregateFunction.COUNT
            return ast.AggregateExpr(AggregateFunction.COUNT_DISTINCT,
                                     self._expr(e.args[0], scope))
        return ast.AggregateExpr(fn, self._expr(e.args[0], scope))

    def _inline_correlated_subqueries(self, e, node: L.LQPNode, scope: Scope):
        """Replace correlated scalar subqueries inside a select-list
        expression with decorrelated value columns (LEFT-joined onto `node`
        via _correlated_scalar_value). Returns (expr', node'); already-
        lowered ast.Expr fragments pass through _expr untouched."""
        if isinstance(e, P.ESubquery):
            status, payload = self._correlated_scalar_value(
                e.subquery, node, scope)
            if status == "ok":
                joined, value_ref = payload
                return value_ref, joined
            return e, node
        if isinstance(e, P.EIn) and e.subquery is not None \
                and isinstance(e.value, P.EColumn):
            # IN-subquery in EXPRESSION position (e.g. inside CASE): LEFT
            # join a distinct marker column and test it for NULL. (x IN set
            # yields NULL when x is NULL in SQL; as a condition that is
            # indistinguishable from FALSE, which this produces.)
            sub_lqp, sub_cols = self._select_any(e.subquery, scope)
            if len(sub_cols) != 1:
                raise SQLTranslationError("IN subquery must return one column")
            key, marker = _gen_name("in_k"), _gen_name("in_m")
            proj = L.ProjectionNode(
                [(key, ast.col(sub_cols[0])), (marker, ast.lit(1))],
                L.DistinctNode(sub_lqp))
            outer_col = scope.resolve(e.value.table, e.value.name)
            joined = L.JoinNode(JoinMode.LEFT, node, proj, outer_col, key)
            m: ast.Expr = ast.IsNull(ast.col(marker))
            return (m if e.negate else ast.Not(m)), joined
        if isinstance(e, P.ECase):
            whens, changed = [], False
            for cnd, val in e.whens:
                nc, node = self._inline_correlated_subqueries(cnd, node, scope)
                nv, node = self._inline_correlated_subqueries(val, node, scope)
                changed = changed or nc is not cnd or nv is not val
                whens.append((nc, nv))
            other = e.otherwise
            if other is not None:
                no, node = self._inline_correlated_subqueries(other, node,
                                                              scope)
                changed = changed or no is not other
                other = no
            if changed:
                e = dataclasses.replace(e, whens=whens, otherwise=other)
            return e, node
        for field in ("left", "right", "value", "operand"):
            sub = getattr(e, field, None)
            if sub is not None and not isinstance(sub, (str, int, float)):
                new, node = self._inline_correlated_subqueries(sub, node,
                                                               scope)
                if new is not sub:
                    e = dataclasses.replace(e, **{field: new})
        if getattr(e, "args", None) and isinstance(e, P.EFunc):
            args, changed = [], False
            for a in e.args:
                na, node = self._inline_correlated_subqueries(a, node, scope)
                changed = changed or na is not a
                args.append(na)
            if changed:
                e = dataclasses.replace(e, args=args)
        return e, node

    def _plain_select(self, sel: P.SelectStmt, node: L.LQPNode, scope: Scope
                      ) -> Tuple[L.LQPNode, List[str]]:
        outputs: List[Tuple[str, ast.Expr]] = []
        names: List[str] = []
        for alias, e in sel.select:
            if e == "*":
                for q, b in scope.all_columns():
                    outputs.append((b, ast.col(q)))
                    names.append(b)
                continue
            name = alias or self._default_name(e)
            if not isinstance(e, str):
                e, node = self._inline_correlated_subqueries(e, node, scope)
            outputs.append((name, self._expr(e, scope)))
            names.append(name)
        return L.ProjectionNode(outputs, node), names

    def _aggregate_select(self, sel: P.SelectStmt, node: L.LQPNode,
                          scope: Scope) -> Tuple[L.LQPNode, List[str]]:
        # 1. group-by keys: plain columns used directly; expressions become
        #    pre-projected computed columns.
        group_cols: List[str] = []
        group_key_of_repr: Dict[str, str] = {}
        pre_outputs: List[Tuple[str, ast.Expr]] = []
        for g in sel.groupby:
            if isinstance(g, P.EColumn):
                q = scope.resolve(g.table, g.name)
                group_cols.append(q)
                group_key_of_repr[repr(g)] = q
            else:
                name = _gen_name("gkey")
                pre_outputs.append((name, self._expr(g, scope)))
                group_cols.append(name)
                group_key_of_repr[repr(g)] = name
        if pre_outputs:
            keep = [q for q, _ in scope.all_columns()]
            node = L.ProjectionNode(keep + pre_outputs, node)

        # 2. collect aggregate expressions from select + having + orderby
        aggs: List[Tuple[str, ast.AggregateExpr]] = []
        agg_name_of_repr: Dict[str, str] = {}

        def register_aggs(e):
            if isinstance(e, (P.ESubquery, P.EExists)):
                return
            if isinstance(e, P.EIn) and e.subquery is not None:
                register_aggs(e.value)
                return
            if isinstance(e, P.EFunc) and e.name in _AGG_FUNCS:
                r = repr(e)
                if r not in agg_name_of_repr:
                    name = _gen_name("agg")
                    agg_name_of_repr[r] = name
                    aggs.append((name, self._agg_expr(e, scope)))
                return
            if dataclasses.is_dataclass(e) and not isinstance(e, type):
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, list):
                        for item in v:
                            if isinstance(item, tuple):
                                for y in item:
                                    if dataclasses.is_dataclass(y):
                                        register_aggs(y)
                            elif dataclasses.is_dataclass(item):
                                register_aggs(item)
                    elif dataclasses.is_dataclass(v):
                        register_aggs(v)

        for _, e in sel.select:
            if e != "*":
                register_aggs(e)
        if sel.having is not None:
            register_aggs(sel.having)
        for e, _ in sel.orderby:
            register_aggs(e)

        agg_node = L.AggregateNode(group_cols, aggs, node)
        result: L.LQPNode = agg_node

        # 3. HAVING over aggregate outputs
        def post_expr(e) -> ast.Expr:
            r = repr(e)
            if r in agg_name_of_repr:
                return ast.col(agg_name_of_repr[r])
            if r in group_key_of_repr:
                return ast.col(group_key_of_repr[r])
            if isinstance(e, P.EColumn):
                q = scope.resolve(e.table, e.name)
                if q in group_cols:
                    return ast.col(q)
                raise SQLTranslationError(
                    f"column {e.name!r} must appear in GROUP BY")
            return self._expr_generic(e, post_expr)

        if sel.having is not None:
            result = L.PredicateNode(post_expr(sel.having), result)

        # 4. final projection to display names
        outputs: List[Tuple[str, ast.Expr]] = []
        names: List[str] = []
        for alias, e in sel.select:
            if e == "*":
                raise SQLTranslationError("SELECT * with GROUP BY")
            name = alias or self._default_name(e)
            outputs.append((name, post_expr(e)))
            names.append(name)
        # ORDER BY may reference aggregates not in the select list
        for e, _ in sel.orderby:
            r = repr(e)
            if r in agg_name_of_repr and all(
                    repr(se) != r for _, se in sel.select if se != "*"):
                hidden = agg_name_of_repr[r]
                outputs.append((hidden, ast.col(hidden)))
        result = L.ProjectionNode(outputs, result)
        return result, names

    def _default_name(self, e) -> str:
        if isinstance(e, P.EColumn):
            return e.name
        if isinstance(e, P.EFunc):
            if e.star:
                return f"{e.name}(*)"
            inner = ",".join(self._default_name(a) for a in e.args)
            return f"{e.name}({inner})"
        return _gen_name("expr")

    # -- expressions ---------------------------------------------------------

    def _expr(self, e, scope: Scope) -> ast.Expr:
        return self._expr_generic(e, lambda x: self._expr(x, scope),
                                  scope=scope)

    def _expr_generic(self, e, rec, scope: Optional[Scope] = None) -> ast.Expr:
        if isinstance(e, ast.Expr):
            return e  # already lowered (decorrelated select-list subqueries)
        if isinstance(e, P.EColumn):
            if scope is None:
                raise SQLTranslationError(f"unresolved column {e.name}")
            return ast.col(scope.resolve(e.table, e.name))
        if isinstance(e, P.ELiteral):
            return ast.lit(e.value)
        if isinstance(e, P.EParam):
            if self.params is None or e.index >= len(self.params):
                raise SQLTranslationError("missing parameter value")
            return ast.lit(self.params[e.index])
        if isinstance(e, P.EBinary):
            if e.op in ("and", "or"):
                return ast.Logical(e.op, rec(e.left), rec(e.right))
            if e.op in _COND_MAP:
                return ast.Comparison(_COND_MAP[e.op], rec(e.left),
                                      rec(e.right))
            if e.op == "||":
                return ast.FunctionCall("concat", [rec(e.left), rec(e.right)])
            return ast.Arithmetic(e.op, rec(e.left), rec(e.right))
        if isinstance(e, P.EUnary):
            if e.op == "not":
                return ast.Not(rec(e.value))
            return ast.Arithmetic("-", ast.lit(0), rec(e.value))
        if isinstance(e, P.EBetween):
            b = ast.Between(rec(e.value), rec(e.lower), rec(e.upper))
            return ast.Not(b) if e.negate else b
        if isinstance(e, P.EIn):
            if e.subquery is not None:
                raise SQLTranslationError(
                    "IN (SELECT ...) only supported as a top-level WHERE "
                    "conjunct")
            return ast.InList(rec(e.value), [rec(o) for o in e.options],
                              e.negate)
        if isinstance(e, P.ELike):
            if not isinstance(e.pattern, P.ELiteral):
                raise SQLTranslationError("LIKE pattern must be a literal")
            return ast.Like(rec(e.value), e.pattern.value, e.negate)
        if isinstance(e, P.EIsNull):
            return ast.IsNull(rec(e.value), e.negate)
        if isinstance(e, P.ECase):
            whens = [(rec(c), rec(v)) for c, v in e.whens]
            return ast.Case(whens, rec(e.otherwise)
                            if e.otherwise is not None else None)
        if isinstance(e, P.ECast):
            if e.type_name not in _TYPE_NAMES:
                raise SQLTranslationError(f"unknown cast type {e.type_name!r}")
            return ast.Cast(rec(e.value), _TYPE_NAMES[e.type_name])
        if isinstance(e, P.EFunc):
            if e.name in _AGG_FUNCS:
                raise SQLTranslationError(
                    f"aggregate {e.name}() in invalid position")
            if e.name in ("substr", "substring"):
                return ast.FunctionCall("substr", [rec(a) for a in e.args])
            if e.name == "concat":
                return ast.FunctionCall("concat", [rec(a) for a in e.args])
            if e.name == "extract":
                # args[0] is the field name literal injected by the parser
                return ast.FunctionCall("extract", [
                    ast.Literal(e.args[0].value), rec(e.args[1])])
            if e.name == "coalesce":
                # COALESCE(a, b, ..., z) == CASE WHEN a IS NOT NULL THEN a
                # WHEN b IS NOT NULL THEN b ... ELSE z END
                if not e.args:
                    raise SQLTranslationError("COALESCE needs arguments")
                args = [rec(a) for a in e.args]
                whens = [(ast.IsNull(a, True), a) for a in args[:-1]]
                return ast.Case(whens, args[-1]) if whens else args[-1]
            raise SQLTranslationError(f"unknown function {e.name!r}")
        if isinstance(e, P.ESubquery):
            sub_lqp, cols = self._select_any(e.subquery, scope or Scope())
            return ScalarSubquery(sub_lqp)
        if isinstance(e, P.EExists):
            raise SQLTranslationError(
                "EXISTS only supported as a top-level WHERE conjunct")
        raise SQLTranslationError(f"cannot translate expression {e}")


_COND_MAP = {
    "=": PredicateCondition.EQUALS,
    "<>": PredicateCondition.NOT_EQUALS,
    "<": PredicateCondition.LESS_THAN,
    "<=": PredicateCondition.LESS_THAN_EQUALS,
    ">": PredicateCondition.GREATER_THAN,
    ">=": PredicateCondition.GREATER_THAN_EQUALS,
}

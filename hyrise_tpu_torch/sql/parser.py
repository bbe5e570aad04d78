"""SQL parser: tokenizer + recursive descent -> parse tree.

Role of the reference's vendored hsql parser (third_party/sql-parser,
flex/bison). From-scratch recursive descent over the SQL subset the
reference exercises (TPC-H + the sqlite_testrunner corpus shapes):
SELECT (joins, subqueries, aggregates, CASE, LIKE/IN/BETWEEN/EXISTS),
INSERT / UPDATE / DELETE, CREATE/DROP VIEW, CREATE/DROP TABLE,
PREPARE / EXECUTE with ? placeholders.

Output is a light parse tree (dataclasses below); sql/translator.py lowers
it to LQP.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# tokens

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]+")
  | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|;|\+|-|\*|/|%|\.|\?|\|\|)
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "like", "between", "is", "null",
    "exists", "case", "when", "then", "else", "end", "cast", "distinct",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "union", "all", "insert", "into", "values", "update", "set", "delete",
    "create", "drop", "view", "table", "asc", "desc", "prepare", "execute",
    "show", "tables", "columns", "int", "integer", "long", "bigint", "float",
    "real", "double", "text", "string", "varchar", "any", "some",
}


# identifiers that terminate a SELECT instead of acting as implicit aliases
SOFT_RESERVED = {"except", "intersect"}


@dataclasses.dataclass
class Token:
    kind: str  # num | str | id | kw | op | qid
    value: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SQLParseError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        v = m.group()
        if kind == "id" and v.lower() in KEYWORDS:
            out.append(Token("kw", v.lower(), m.start()))
        elif kind == "qid":
            out.append(Token("id", v[1:-1], m.start()))
        else:
            out.append(Token(kind, v, m.start()))
    return out


class SQLParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# parse tree

@dataclasses.dataclass
class SelectStmt:
    select: List[Tuple[Optional[str], object]]  # (alias, expr) or (None, '*')
    distinct: bool
    from_refs: List["TableRef"]
    joins: List["JoinClause"]
    where: Optional[object]
    groupby: List[object]
    having: Optional[object]
    orderby: List[Tuple[object, str]]  # (expr, 'asc'|'desc')
    limit: Optional[int]


@dataclasses.dataclass
class TableRef:
    name: Optional[str]          # base table name
    subquery: Optional[SelectStmt]
    alias: Optional[str]


@dataclasses.dataclass
class JoinClause:
    kind: str                    # inner|left|right|full|cross
    ref: TableRef
    on: Optional[object]


@dataclasses.dataclass
class InsertStmt:
    table: str
    columns: Optional[List[str]]
    values: Optional[List[List[object]]]
    select: Optional[SelectStmt]


@dataclasses.dataclass
class UpdateStmt:
    table: str
    assignments: List[Tuple[str, object]]
    where: Optional[object]


@dataclasses.dataclass
class DeleteStmt:
    table: str
    where: Optional[object]


@dataclasses.dataclass
class CreateViewStmt:
    name: str
    select: SelectStmt


@dataclasses.dataclass
class DropViewStmt:
    name: str


@dataclasses.dataclass
class CreateTableStmt:
    name: str
    columns: List[Tuple[str, str, bool]]  # (name, type, nullable)


@dataclasses.dataclass
class DropTableStmt:
    name: str


@dataclasses.dataclass
class PrepareStmt:
    name: str
    stmt: object


@dataclasses.dataclass
class ExecuteStmt:
    name: str
    params: List[object]


@dataclasses.dataclass
class ShowStmt:
    what: str                    # tables | columns
    table: Optional[str] = None


@dataclasses.dataclass
class ExplainStmt:
    stmt: object


@dataclasses.dataclass
class SetOpStmt:
    """UNION / UNION ALL / EXCEPT / INTERSECT of two selects."""

    op: str  # union | union_all | except | intersect
    left: object
    right: object
    orderby: list = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


# expression tree nodes (parser-level; translator maps to expression.ast)

@dataclasses.dataclass
class EColumn:
    table: Optional[str]
    name: str


@dataclasses.dataclass
class ELiteral:
    value: object


@dataclasses.dataclass
class EParam:
    index: int


@dataclasses.dataclass
class EBinary:
    op: str
    left: object
    right: object


@dataclasses.dataclass
class EUnary:
    op: str
    value: object


@dataclasses.dataclass
class EFunc:
    name: str
    args: List[object]
    distinct: bool = False
    star: bool = False


@dataclasses.dataclass
class ECase:
    whens: List[Tuple[object, object]]
    otherwise: Optional[object]


@dataclasses.dataclass
class ECast:
    value: object
    type_name: str


@dataclasses.dataclass
class EBetween:
    value: object
    lower: object
    upper: object
    negate: bool = False


@dataclasses.dataclass
class EIn:
    value: object
    options: Optional[List[object]]
    subquery: Optional[SelectStmt]
    negate: bool = False


@dataclasses.dataclass
class ELike:
    value: object
    pattern: object
    negate: bool = False


@dataclasses.dataclass
class EIsNull:
    value: object
    negate: bool = False


@dataclasses.dataclass
class EExists:
    subquery: SelectStmt
    negate: bool = False


@dataclasses.dataclass
class ESubquery:
    subquery: SelectStmt


# ---------------------------------------------------------------------------
# parser

class Parser:
    def __init__(self, tokens: List[Token], sql: str):
        self.toks = tokens
        self.sql = sql
        self.i = 0
        self.n_params = 0

    # -- token helpers -------------------------------------------------------

    def peek(self, k: int = 0) -> Optional[Token]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "op" and t.value in ops

    def take(self) -> Token:
        t = self.peek()
        if t is None:
            raise SQLParseError("unexpected end of input")
        self.i += 1
        return t

    def expect_kw(self, kw: str) -> Token:
        t = self.take()
        if t.kind != "kw" or t.value != kw:
            raise SQLParseError(f"expected {kw.upper()}, got {t.value!r} "
                                f"at {t.pos}")
        return t

    def expect_op(self, op: str) -> Token:
        t = self.take()
        if t.kind != "op" or t.value != op:
            raise SQLParseError(f"expected {op!r}, got {t.value!r} at {t.pos}")
        return t

    def ident(self) -> str:
        t = self.take()
        if t.kind == "id":
            return t.value
        if t.kind == "kw":  # allow non-reserved-ish keywords as identifiers
            return t.value
        raise SQLParseError(f"expected identifier, got {t.value!r} at {t.pos}")

    # -- statements ----------------------------------------------------------

    def parse_statements(self) -> List[object]:
        stmts = []
        while self.peek() is not None:
            if self.at_op(";"):
                self.take()
                continue
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self):
        if self.at_kw("select"):
            return self.parse_select_compound()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("update"):
            return self.parse_update()
        if self.at_kw("delete"):
            return self.parse_delete()
        if self.at_kw("create"):
            return self.parse_create()
        if self.at_kw("drop"):
            return self.parse_drop()
        if self.at_kw("prepare"):
            return self.parse_prepare()
        if self.at_kw("execute"):
            return self.parse_execute()
        if self.at_kw("show"):
            return self.parse_show()
        t = self.peek()
        if t is not None and t.kind == "id" and t.value.lower() == "explain":
            self.take()
            return ExplainStmt(self.parse_statement())
        raise SQLParseError(f"cannot parse statement at {t.value!r} ({t.pos})")

    def parse_select_compound(self):
        """SELECT ... [UNION [ALL] | EXCEPT | INTERSECT SELECT ...]*
        with trailing ORDER BY / LIMIT applying to the compound."""
        left = self.parse_select()
        out = left
        while True:
            t = self.peek()
            op = None
            if self.at_kw("union"):
                self.take()
                op = "union"
                if self.at_kw("all"):
                    self.take()
                    op = "union_all"
            elif t is not None and t.kind == "id" and \
                    t.value.lower() in ("except", "intersect"):
                op = self.take().value.lower()
            if op is None:
                return out
            right = self.parse_select()
            orderby, limit = [], None
            # trailing ORDER BY / LIMIT bound to the whole compound: the
            # inner parse consumed them into `right`; hoist them out
            if right.orderby or right.limit is not None:
                orderby, limit = right.orderby, right.limit
                right.orderby, right.limit = [], None
            out = SetOpStmt(op, out, right, orderby, limit)

    def parse_select(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = False
        if self.at_kw("distinct"):
            self.take()
            distinct = True
        select: List[Tuple[Optional[str], object]] = []
        while True:
            if self.at_op("*"):
                self.take()
                select.append((None, "*"))
            else:
                e = self.parse_expr()
                alias = None
                if self.at_kw("as"):
                    self.take()
                    alias = self.ident()
                elif self.peek() is not None and self.peek().kind == "id" \
                        and self.peek().value.lower() not in SOFT_RESERVED:
                    alias = self.take().value
                select.append((alias, e))
            if self.at_op(","):
                self.take()
                continue
            break

        from_refs: List[TableRef] = []
        joins: List[JoinClause] = []
        if self.at_kw("from"):
            self.take()
            from_refs.append(self.parse_table_ref())
            while True:
                if self.at_op(","):
                    self.take()
                    from_refs.append(self.parse_table_ref())
                    continue
                jk = self._try_join_kind()
                if jk is not None:
                    ref = self.parse_table_ref()
                    on = None
                    if self.at_kw("on"):
                        self.take()
                        on = self.parse_expr()
                    joins.append(JoinClause(jk, ref, on))
                    continue
                break

        where = None
        if self.at_kw("where"):
            self.take()
            where = self.parse_expr()
        groupby: List[object] = []
        if self.at_kw("group"):
            self.take()
            self.expect_kw("by")
            groupby.append(self.parse_expr())
            while self.at_op(","):
                self.take()
                groupby.append(self.parse_expr())
        having = None
        if self.at_kw("having"):
            self.take()
            having = self.parse_expr()
        orderby: List[Tuple[object, str]] = []
        if self.at_kw("order"):
            self.take()
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                d = "asc"
                if self.at_kw("asc", "desc"):
                    d = self.take().value
                orderby.append((e, d))
                if self.at_op(","):
                    self.take()
                    continue
                break
        limit = None
        if self.at_kw("limit"):
            self.take()
            t = self.take()
            if t.kind != "num":
                raise SQLParseError(f"expected LIMIT count, got {t.value!r}")
            limit = int(t.value)
        return SelectStmt(select, distinct, from_refs, joins, where, groupby,
                          having, orderby, limit)

    def _try_join_kind(self) -> Optional[str]:
        if self.at_kw("join"):
            self.take()
            return "inner"
        if self.at_kw("inner"):
            self.take()
            self.expect_kw("join")
            return "inner"
        if self.at_kw("cross"):
            self.take()
            self.expect_kw("join")
            return "cross"
        if self.at_kw("left", "right", "full"):
            kind = self.take().value
            if self.at_kw("outer"):
                self.take()
            self.expect_kw("join")
            return kind
        return None

    def parse_table_ref(self) -> TableRef:
        if self.at_op("("):
            self.take()
            sub = self.parse_select_compound()
            self.expect_op(")")
            alias = None
            if self.at_kw("as"):
                self.take()
                alias = self.ident()
            elif self.peek() is not None and self.peek().kind == "id":
                alias = self.take().value
            return TableRef(None, sub, alias)
        name = self.ident()
        alias = None
        if self.at_kw("as"):
            self.take()
            alias = self.ident()
        elif self.peek() is not None and self.peek().kind == "id" \
                and self.peek().value.lower() not in SOFT_RESERVED:
            alias = self.take().value
        return TableRef(name, None, alias)

    def parse_insert(self) -> InsertStmt:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        columns = None
        if self.at_op("("):
            self.take()
            columns = [self.ident()]
            while self.at_op(","):
                self.take()
                columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("values"):
            self.take()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.at_op(","):
                    self.take()
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if self.at_op(","):
                    self.take()
                    continue
                break
            return InsertStmt(table, columns, rows, None)
        sel = self.parse_select()
        return InsertStmt(table, columns, None, sel)

    def parse_update(self) -> UpdateStmt:
        self.expect_kw("update")
        table = self.ident()
        self.expect_kw("set")
        assignments = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assignments.append((col, self.parse_expr()))
            if self.at_op(","):
                self.take()
                continue
            break
        where = None
        if self.at_kw("where"):
            self.take()
            where = self.parse_expr()
        return UpdateStmt(table, assignments, where)

    def parse_delete(self) -> DeleteStmt:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident()
        where = None
        if self.at_kw("where"):
            self.take()
            where = self.parse_expr()
        return DeleteStmt(table, where)

    def parse_create(self):
        self.expect_kw("create")
        if self.at_kw("view"):
            self.take()
            name = self.ident()
            # optional column list ignored for now
            self.expect_kw("as")
            sel = self.parse_select()
            return CreateViewStmt(name, sel)
        self.expect_kw("table")
        name = self.ident()
        self.expect_op("(")
        cols = []
        while True:
            cname = self.ident()
            t = self.take()
            type_name = t.value
            nullable = False
            if self.at_kw("null"):
                self.take()
                nullable = True
            if self.at_kw("not"):
                self.take()
                self.expect_kw("null")
                nullable = False
            cols.append((cname, type_name, nullable))
            if self.at_op(","):
                self.take()
                continue
            break
        self.expect_op(")")
        return CreateTableStmt(name, cols)

    def parse_drop(self):
        self.expect_kw("drop")
        if self.at_kw("view"):
            self.take()
            return DropViewStmt(self.ident())
        self.expect_kw("table")
        return DropTableStmt(self.ident())

    def parse_prepare(self) -> PrepareStmt:
        self.expect_kw("prepare")
        name = self.ident()
        if self.at_kw("from"):  # PREPARE x FROM 'select ...'
            self.take()
            t = self.take()
            if t.kind != "str":
                raise SQLParseError("expected string after PREPARE .. FROM")
            inner = parse_sql(t.value[1:-1].replace("''", "'"))
            assert len(inner) == 1
            return PrepareStmt(name, inner[0])
        self.expect_kw("as")
        return PrepareStmt(name, self.parse_statement())

    def parse_execute(self) -> ExecuteStmt:
        self.expect_kw("execute")
        name = self.ident()
        params: List[object] = []
        if self.at_op("("):
            self.take()
            if not self.at_op(")"):
                params.append(self.parse_expr())
                while self.at_op(","):
                    self.take()
                    params.append(self.parse_expr())
            self.expect_op(")")
        return ExecuteStmt(name, params)

    def parse_show(self) -> ShowStmt:
        self.expect_kw("show")
        if self.at_kw("tables"):
            self.take()
            return ShowStmt("tables")
        self.expect_kw("columns")
        if self.at_kw("from"):
            self.take()
        return ShowStmt("columns", self.ident())

    # -- expressions (precedence climbing) -----------------------------------

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.at_kw("or"):
            self.take()
            e = EBinary("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.at_kw("and"):
            self.take()
            e = EBinary("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.at_kw("not"):
            self.take()
            if self.at_kw("exists"):
                self.take()
                self.expect_op("(")
                sub = self.parse_select_compound()
                self.expect_op(")")
                return EExists(sub, negate=True)
            return EUnary("not", self.parse_not())
        return self.parse_comparison()

    def _quantified_to_exists(self, x, op, quant, sub):
        """x OP ANY (SELECT c ...)  -> EXISTS(... WHERE x OP c)
        x OP ALL (SELECT c ...)  -> NOT EXISTS(... WHERE x IS NULL
                                      OR NOT(x OP c) OR c IS NULL)
        Exact under WHERE-clause filtering (UNKNOWN == FALSE): the ALL form
        keeps vacuous truth on empty sets and rejects rows where the
        quantifier's value would be UNKNOWN (NULL x against a non-empty
        set, or a NULL element that cannot be proven to satisfy OP)."""
        if not isinstance(sub, SelectStmt) or len(sub.select) != 1 \
                or sub.select[0][1] == "*":
            raise SQLParseError(
                "quantified comparison needs a single-column subquery")
        c = sub.select[0][1]
        if quant in ("any", "some"):
            cond = EBinary(op, x, c)
            negate = False
        else:
            cond = EBinary("or",
                           EBinary("or", EIsNull(x),
                                   EUnary("not", EBinary(op, x, c))),
                           EIsNull(c))
            negate = True
        new_where = cond if sub.where is None \
            else EBinary("and", sub.where, cond)
        sub2 = dataclasses.replace(sub, where=new_where)
        return EExists(sub2, negate=negate)

    def parse_comparison(self):
        e = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.take().value
                if op == "!=":
                    op = "<>"
                if self.at_kw("all", "any", "some"):
                    # quantified comparison: rewrite to (NOT) EXISTS with
                    # the comparison folded into the subquery's WHERE
                    # (NULL-correct under WHERE's FALSE==UNKNOWN filtering)
                    quant = self.take().value
                    self.expect_op("(")
                    sub = self.parse_select_compound()
                    self.expect_op(")")
                    e = self._quantified_to_exists(e, op, quant, sub)
                    continue
                rhs = self.parse_additive()
                e = EBinary(op, e, rhs)
                continue
            negate = False
            if self.at_kw("not") and self.peek(1) is not None and \
                    self.peek(1).kind == "kw" and \
                    self.peek(1).value in ("in", "like", "between"):
                self.take()
                negate = True
            if self.at_kw("between"):
                self.take()
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                e = EBetween(e, lo, hi, negate)
                continue
            if self.at_kw("in"):
                self.take()
                self.expect_op("(")
                if self.at_kw("select"):
                    sub = self.parse_select_compound()
                    self.expect_op(")")
                    e = EIn(e, None, sub, negate)
                else:
                    opts = [self.parse_expr()]
                    while self.at_op(","):
                        self.take()
                        opts.append(self.parse_expr())
                    self.expect_op(")")
                    e = EIn(e, opts, None, negate)
                continue
            if self.at_kw("like"):
                self.take()
                e = ELike(e, self.parse_additive(), negate)
                continue
            if self.at_kw("is"):
                self.take()
                neg = False
                if self.at_kw("not"):
                    self.take()
                    neg = True
                self.expect_kw("null")
                e = EIsNull(e, neg)
                continue
            return e

    def parse_additive(self):
        e = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.take().value
            e = EBinary(op, e, self.parse_multiplicative())
        return e

    def parse_multiplicative(self):
        e = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.take().value
            e = EBinary(op, e, self.parse_unary())
        return e

    def parse_unary(self):
        if self.at_op("-"):
            self.take()
            return EUnary("-", self.parse_unary())
        if self.at_op("+"):
            self.take()
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t is None:
            raise SQLParseError("unexpected end of expression")
        if t.kind == "num":
            self.take()
            v = float(t.value) if ("." in t.value) else int(t.value)
            return ELiteral(v)
        if t.kind == "str":
            self.take()
            return ELiteral(t.value[1:-1].replace("''", "'"))
        if t.kind == "op" and t.value == "?":
            self.take()
            self.n_params += 1
            return EParam(self.n_params - 1)
        if t.kind == "kw" and t.value == "null":
            self.take()
            return ELiteral(None)
        if t.kind == "kw" and t.value == "exists":
            self.take()
            self.expect_op("(")
            sub = self.parse_select_compound()
            self.expect_op(")")
            return EExists(sub)
        if t.kind == "kw" and t.value == "case":
            return self.parse_case()
        if t.kind == "kw" and t.value == "cast":
            self.take()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            type_name = self.take().value
            self.expect_op(")")
            return ECast(e, type_name)
        if t.kind == "op" and t.value == "(":
            self.take()
            if self.at_kw("select"):
                sub = self.parse_select_compound()
                self.expect_op(")")
                return ESubquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind in ("id", "kw"):
            name = self.take().value
            # function call?
            if self.at_op("("):
                self.take()
                if name.lower() == "extract":
                    # EXTRACT(YEAR|MONTH|DAY FROM expr)
                    field = self.take().value.lower()
                    self.expect_kw("from")
                    arg = self.parse_expr()
                    self.expect_op(")")
                    return EFunc("extract", [ELiteral(field), arg], False,
                                 False)
                distinct = False
                star = False
                args: List[object] = []
                if self.at_kw("distinct"):
                    self.take()
                    distinct = True
                if self.at_op("*"):
                    self.take()
                    star = True
                elif not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.at_op(","):
                        self.take()
                        args.append(self.parse_expr())
                self.expect_op(")")
                return EFunc(name.lower(), args, distinct, star)
            # qualified column?
            if self.at_op("."):
                self.take()
                col = self.ident()
                return EColumn(name, col)
            return EColumn(None, name)
        raise SQLParseError(f"unexpected token {t.value!r} at {t.pos}")

    def parse_case(self):
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            # simple CASE: CASE x WHEN v THEN r ... == CASE WHEN x = v ...
            operand = self.parse_expr()
        whens = []
        otherwise = None
        while self.at_kw("when"):
            self.take()
            c = self.parse_expr()
            if operand is not None:
                c = EBinary("=", operand, c)
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        if self.at_kw("else"):
            self.take()
            otherwise = self.parse_expr()
        self.expect_kw("end")
        return ECase(whens, otherwise)


def parse_sql(sql: str) -> List[object]:
    p = Parser(tokenize(sql), sql)
    return p.parse_statements()

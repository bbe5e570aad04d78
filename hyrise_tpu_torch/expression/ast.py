"""Expression trees.

Analogue of the reference's expression layer (reference:
src/lib/expression/abstract_expression.hpp and its ~20 subclasses:
arithmetic, predicates, case, cast, function, in, exists, aggregate, column
references, subselects). Host-side immutable trees; evaluation is compiled
into closures over torch tensors by evaluator.py. A copy of
hyrise_tpu/expression/ast.py, pinned by tests/test_torch_evaluator.py.

Convenience constructors `col("a")`, `lit(3)` and rich operators on Expr let
query plans read naturally:  (col("a") + 1 < col("b")) & col("c").like("x%").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from hyrise_tpu_torch.types import AggregateFunction, DataType, PredicateCondition


class Expr:
    # -- operator sugar ------------------------------------------------------
    def __add__(self, o): return Arithmetic("+", self, _wrap(o))
    def __radd__(self, o): return Arithmetic("+", _wrap(o), self)
    def __sub__(self, o): return Arithmetic("-", self, _wrap(o))
    def __rsub__(self, o): return Arithmetic("-", _wrap(o), self)
    def __mul__(self, o): return Arithmetic("*", self, _wrap(o))
    def __rmul__(self, o): return Arithmetic("*", _wrap(o), self)
    def __truediv__(self, o): return Arithmetic("/", self, _wrap(o))
    def __rtruediv__(self, o): return Arithmetic("/", _wrap(o), self)
    def __mod__(self, o): return Arithmetic("%", self, _wrap(o))
    def __neg__(self): return Arithmetic("-", Literal(0), self)

    def __eq__(self, o): return Comparison(PredicateCondition.EQUALS, self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return Comparison(PredicateCondition.NOT_EQUALS, self, _wrap(o))  # type: ignore[override]
    def __lt__(self, o): return Comparison(PredicateCondition.LESS_THAN, self, _wrap(o))
    def __le__(self, o): return Comparison(PredicateCondition.LESS_THAN_EQUALS, self, _wrap(o))
    def __gt__(self, o): return Comparison(PredicateCondition.GREATER_THAN, self, _wrap(o))
    def __ge__(self, o): return Comparison(PredicateCondition.GREATER_THAN_EQUALS, self, _wrap(o))

    def __and__(self, o): return Logical("and", self, _wrap(o))
    def __or__(self, o): return Logical("or", self, _wrap(o))
    def __invert__(self): return Not(self)

    def between(self, lo, hi): return Between(self, _wrap(lo), _wrap(hi))
    def isin(self, values): return InList(self, [_wrap(v) for v in values])
    def notin(self, values): return InList(self, [_wrap(v) for v in values], negate=True)
    def like(self, pattern: str): return Like(self, pattern)
    def not_like(self, pattern: str): return Like(self, pattern, negate=True)
    def is_null(self): return IsNull(self)
    def is_not_null(self): return IsNull(self, negate=True)
    def cast(self, dtype: DataType): return Cast(self, dtype)
    def substr(self, start, length): return FunctionCall("substr", [self, _wrap(start), _wrap(length)])

    def alias(self, name: str) -> Tuple[str, "Expr"]:
        return (name, self)

    # hashability despite overloaded __eq__
    def __hash__(self):
        return id(self)

    def columns(self) -> List[str]:
        """All referenced column names (pre-order, with duplicates removed)."""
        out: List[str] = []
        def walk(e: Expr):
            if isinstance(e, ColumnRef):
                if e.name not in out:
                    out.append(e.name)
            for c in e.children():
                walk(c)
        walk(self)
        return out

    def children(self) -> Sequence["Expr"]:
        return ()


@dataclasses.dataclass(eq=False)
class ColumnRef(Expr):
    name: str

    def __repr__(self): return f"col({self.name!r})"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    value: object  # python int/float/str/None

    def __repr__(self): return f"lit({self.value!r})"


class ComputedValue(Literal):
    """A value the plan computed before it runs (an uncorrelated scalar
    subquery's result), standing where a literal stands. A column compares
    with it in their common type, as with the same subquery correlated,
    where a literal written in the text takes the column's type."""


@dataclasses.dataclass(eq=False)
class Arithmetic(Expr):
    op: str  # + - * / %
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(eq=False)
class Comparison(Expr):
    cond: PredicateCondition
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} {self.cond.value} {self.right})"


@dataclasses.dataclass(eq=False)
class Between(Expr):
    value: Expr
    lower: Expr
    upper: Expr

    def children(self): return (self.value, self.lower, self.upper)


@dataclasses.dataclass(eq=False)
class InList(Expr):
    value: Expr
    options: List[Expr]
    negate: bool = False

    def children(self): return (self.value, *self.options)


@dataclasses.dataclass(eq=False)
class Like(Expr):
    value: Expr
    pattern: str
    negate: bool = False

    def children(self): return (self.value,)


@dataclasses.dataclass(eq=False)
class IsNull(Expr):
    value: Expr
    negate: bool = False

    def children(self): return (self.value,)


@dataclasses.dataclass(eq=False)
class Logical(Expr):
    op: str  # and / or
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)


@dataclasses.dataclass(eq=False)
class Not(Expr):
    value: Expr

    def children(self): return (self.value,)


@dataclasses.dataclass(eq=False)
class Case(Expr):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE e END."""

    whens: List[Tuple[Expr, Expr]]
    otherwise: Optional[Expr] = None

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        if self.otherwise is not None:
            out.append(self.otherwise)
        return tuple(out)


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    value: Expr
    dtype: DataType

    def children(self): return (self.value,)


@dataclasses.dataclass(eq=False)
class FunctionCall(Expr):
    """String functions (reference: expression/function_expression.hpp —
    SUBSTR and CONCAT are what Hyrise supports)."""

    name: str  # substr | concat
    args: List[Expr]

    def children(self): return tuple(self.args)


@dataclasses.dataclass(eq=False)
class AggregateExpr(Expr):
    """Aggregate over an argument expression; only valid inside the
    Aggregate operator's aggregate list (reference:
    expression/aggregate_expression.hpp)."""

    fn: AggregateFunction
    arg: Optional[Expr]  # None for COUNT(*)
    distinct: bool = False

    def children(self):
        return (self.arg,) if self.arg is not None else ()


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal(v)


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def lit(v) -> Literal:
    return Literal(v)


# Aggregate constructors
def sum_(e: Expr) -> AggregateExpr: return AggregateExpr(AggregateFunction.SUM, e)
def min_(e: Expr) -> AggregateExpr: return AggregateExpr(AggregateFunction.MIN, e)
def max_(e: Expr) -> AggregateExpr: return AggregateExpr(AggregateFunction.MAX, e)
def avg_(e: Expr) -> AggregateExpr: return AggregateExpr(AggregateFunction.AVG, e)
def count_(e: Optional[Expr] = None) -> AggregateExpr:
    return AggregateExpr(AggregateFunction.COUNT, e)
def count_distinct(e: Expr) -> AggregateExpr:
    return AggregateExpr(AggregateFunction.COUNT_DISTINCT, e)

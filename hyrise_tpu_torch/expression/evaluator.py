"""Expression evaluation over torch tensors.

Port of hyrise_tpu/expression/evaluator.py, in the same two phases:

1. `compile_expression(expr, table)` — HOST phase. Resolves dtypes and does
   all dictionary work (string literals -> code-space thresholds, LIKE
   patterns -> per-code boolean lookup tables, SUBSTR -> dictionary
   rewrite, cross-dictionary merges) and returns a `CompiledExpr` whose
   `fn` maps device tensors to device tensors. This is the reference's
   dictionary-scan trick (compare ValueIDs, not values) for every string
   expression.
2. `fn(env)` — DEVICE phase. env maps column name -> (data, validity|None);
   returns (data, validity|None).

Types are never left to torch's promotion rules, whose treatment of 0-dim
tensors and Python scalars differs from JAX's with x64: every operand is
cast to the result or comparison type first, integer `/` truncates toward
zero and `%` takes the dividend's sign (C semantics, jax.lax.div/rem), and
both yield 0 for a zero divisor.

NULL semantics: SQL three-valued logic (Kleene AND/OR), comparisons with
NULL are NULL, IS NULL inspects validity.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.storage.column import Column, merge_dictionaries
from hyrise_tpu_torch.storage.table import Table
from hyrise_tpu_torch.types import DataType, PredicateCondition, common_numeric_type

Env = Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]
Value = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (data, validity|None)


@dataclasses.dataclass
class CompiledExpr:
    dtype: DataType
    dictionary: Optional[np.ndarray]  # for STRING results
    required: List[str]               # column names the fn reads from env
    fn: Callable[[Env], Value]
    is_bool: bool = False             # a predicate: data is a bool tensor


BOOL = "bool"  # internal marker dtype for predicate results


@dataclasses.dataclass
class _C:
    """Internal compiled node: dtype is DataType or the string 'bool'."""

    dtype: object
    dictionary: Optional[np.ndarray]
    fn: Callable[[Env], Value]


def like_to_regex(pattern: str) -> "re.Pattern":
    """SQL LIKE pattern -> anchored regex (reference:
    like_table_scan_impl.cpp sqllike_to_regex)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), flags=re.DOTALL)


def _and_validity(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cast_to(data: torch.Tensor, dt: DataType) -> torch.Tensor:
    return data.to(dt.torch_dtype)


def _literal_dtype(v) -> DataType:
    if v is None:
        return DataType.NULL
    if isinstance(v, bool):
        return DataType.INT32
    if isinstance(v, int):
        return DataType.INT32 if -(2**31) <= v < 2**31 else DataType.INT64
    if isinstance(v, float):
        return DataType.FLOAT64
    if isinstance(v, str):
        return DataType.STRING
    raise TypeError(f"unsupported literal {v!r}")


def _lookup(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut[codes], with codes clamped into the table (dead rows may hold
    any code)."""
    return lut[codes.clamp(0, lut.shape[0] - 1)]


class _Compiler:
    def __init__(self, table: Table):
        self.table = table
        self.device = table.device

    def _const(self, values, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.device)

    def _full(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((self.table.capacity,), value, dtype=dtype,
                          device=self.device)

    # -- entry ---------------------------------------------------------------

    def compile(self, e: ast.Expr) -> _C:
        if isinstance(e, ast.ColumnRef):
            return self._column(e)
        if isinstance(e, ast.Literal):
            return self._literal(e)
        if isinstance(e, ast.Arithmetic):
            return self._arithmetic(e)
        if isinstance(e, ast.Comparison):
            return self._comparison(e)
        if isinstance(e, ast.Between):
            low = ast.Comparison(PredicateCondition.GREATER_THAN_EQUALS, e.value, e.lower)
            high = ast.Comparison(PredicateCondition.LESS_THAN_EQUALS, e.value, e.upper)
            return self.compile(ast.Logical("and", low, high))
        if isinstance(e, ast.InList):
            return self._in_list(e)
        if isinstance(e, ast.Like):
            return self._like(e)
        if isinstance(e, ast.IsNull):
            return self._is_null(e)
        if isinstance(e, ast.Logical):
            return self._logical(e)
        if isinstance(e, ast.Not):
            return self._not(e)
        if isinstance(e, ast.Case):
            return self._case(e)
        if isinstance(e, ast.Cast):
            return self._cast(e)
        if isinstance(e, ast.FunctionCall):
            return self._function(e)
        raise NotImplementedError(f"cannot evaluate {type(e).__name__}")

    # -- leaves --------------------------------------------------------------

    def _column(self, e: ast.ColumnRef) -> _C:
        c = self.table.column(e.name)
        name = e.name

        def fn(env: Env) -> Value:
            return env[name]

        return _C(c.dtype, c.dictionary, fn)

    def _literal(self, e: ast.Literal) -> _C:
        v = e.value
        dt = _literal_dtype(v)
        if dt is DataType.NULL:
            def fn(env: Env) -> Value:
                return (self._full(0, torch.int32), self._full(False, torch.bool))
            return _C(DataType.NULL, None, fn)
        if dt is DataType.STRING:
            # String literals stay host-side; comparisons resolve them against
            # dictionaries. Represent as a 1-element dictionary, all codes 0.
            def fn(env: Env) -> Value:
                return (self._full(0, torch.int32), None)
            return _C(DataType.STRING, np.array([v]), fn)

        def fn(env: Env) -> Value:
            return (self._full(v, dt.torch_dtype), None)

        return _C(dt, None, fn)

    # -- numeric -------------------------------------------------------------

    def _arithmetic(self, e: ast.Arithmetic) -> _C:
        lc, rc = self.compile(e.left), self.compile(e.right)
        if lc.dtype == BOOL or rc.dtype == BOOL:
            raise TypeError("arithmetic on boolean")
        if DataType.STRING in (lc.dtype, rc.dtype):
            raise TypeError(f"arithmetic on string operand: {e}")
        out_dt = common_numeric_type(lc.dtype, rc.dtype)
        op = e.op
        integral = out_dt.is_integral

        def fn(env: Env) -> Value:
            (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
            ld, rd = _cast_to(ld, out_dt), _cast_to(rd, out_dt)
            if op == "+":
                data = ld + rd
            elif op == "-":
                data = ld - rd
            elif op == "*":
                data = ld * rd
            elif op == "/":
                if integral:
                    # C-style truncating division; guard /0 (returns 0).
                    zero = rd == 0
                    safe = torch.where(zero, torch.ones_like(rd), rd)
                    data = torch.where(zero, torch.zeros_like(ld),
                                       torch.div(ld, safe, rounding_mode="trunc"))
                else:
                    data = ld / rd
            elif op == "%":
                # C remainder (sign of the dividend); guard %0 (returns 0).
                zero = rd == 0
                safe = torch.where(zero, torch.ones_like(rd), rd)
                data = torch.where(zero, torch.zeros_like(ld), torch.fmod(ld, safe))
            else:
                raise ValueError(op)
            return data, _and_validity(lv, rv)

        return _C(out_dt, None, fn)

    # -- comparisons ---------------------------------------------------------

    def _comparison(self, e: ast.Comparison) -> _C:
        lc, rc = self.compile(e.left), self.compile(e.right)
        cond = e.cond

        # String comparisons resolve via dictionaries on host.
        if lc.dtype is DataType.STRING or rc.dtype is DataType.STRING:
            return self._string_comparison(e, lc, rc)

        if lc.dtype is DataType.NULL or rc.dtype is DataType.NULL:
            def null_fn(env: Env) -> Value:
                return (self._full(False, torch.bool), self._full(False, torch.bool))

            return _C(BOOL, None, null_fn)

        # Column vs literal: cast the literal to the column dtype (the
        # reference casts the scan value to the column type).
        if isinstance(e.left, ast.ColumnRef) and isinstance(e.right, ast.Literal):
            cmp_dt = lc.dtype
        elif isinstance(e.right, ast.ColumnRef) and isinstance(e.left, ast.Literal):
            cmp_dt = rc.dtype
        else:
            cmp_dt = common_numeric_type(lc.dtype, rc.dtype)

        def fn(env: Env) -> Value:
            (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
            ld, rd = _cast_to(ld, cmp_dt), _cast_to(rd, cmp_dt)
            return _apply_cmp(cond, ld, rd), _and_validity(lv, rv)

        return _C(BOOL, None, fn)

    def _string_comparison(self, e: ast.Comparison, lc: _C, rc: _C) -> _C:
        cond = e.cond
        if not (lc.dtype is DataType.STRING and rc.dtype is DataType.STRING):
            raise TypeError(f"cannot compare string with non-string: {e}")

        l_lit = isinstance(e.left, ast.Literal)
        r_lit = isinstance(e.right, ast.Literal)
        if l_lit and r_lit:
            result = _apply_cmp_host(cond, e.left.value, e.right.value)

            def const_fn(env: Env) -> Value:
                return (self._full(result, torch.bool), None)

            return _C(BOOL, None, const_fn)

        if l_lit or r_lit:
            # literal side -> threshold rewrite in code space
            col_c = rc if l_lit else lc
            value = e.left.value if l_lit else e.right.value
            c = cond.flipped() if l_lit else cond
            d = col_c.dictionary
            lo = int(np.searchsorted(d, value, side="left"))
            hi = int(np.searchsorted(d, value, side="right"))
            exists = lo < hi

            def fn(env: Env) -> Value:
                codes, v = col_c.fn(env)
                if c is PredicateCondition.EQUALS:
                    data = (codes == lo) if exists else torch.zeros_like(codes, dtype=torch.bool)
                elif c is PredicateCondition.NOT_EQUALS:
                    data = (codes != lo) if exists else torch.ones_like(codes, dtype=torch.bool)
                elif c is PredicateCondition.LESS_THAN:
                    data = codes < lo
                elif c is PredicateCondition.LESS_THAN_EQUALS:
                    data = codes < hi
                elif c is PredicateCondition.GREATER_THAN:
                    data = codes >= hi
                elif c is PredicateCondition.GREATER_THAN_EQUALS:
                    data = codes >= lo
                else:
                    raise ValueError(c)
                return data, v

            return _C(BOOL, None, fn)

        # column vs column: align dictionaries.
        same = (lc.dictionary is rc.dictionary) or (
            len(lc.dictionary) == len(rc.dictionary)
            and bool(np.array_equal(lc.dictionary, rc.dictionary)))
        if same:
            def fn(env: Env) -> Value:
                (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
                return _apply_cmp(cond, ld, rd), _and_validity(lv, rv)

            return _C(BOOL, None, fn)

        _, remap_l, remap_r = merge_dictionaries(lc.dictionary, rc.dictionary)
        rl = self._const(remap_l, torch.int32)
        rr = self._const(remap_r, torch.int32)

        def fn(env: Env) -> Value:
            (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
            return (_apply_cmp(cond, _lookup(rl, ld), _lookup(rr, rd)),
                    _and_validity(lv, rv))

        return _C(BOOL, None, fn)

    def _in_list(self, e: ast.InList) -> _C:
        vc = self.compile(e.value)
        negate = e.negate
        values = []
        for o in e.options:
            if not isinstance(o, ast.Literal):
                raise NotImplementedError("IN with non-literal options")
            values.append(o.value)
        if vc.dtype is DataType.STRING:
            d = vc.dictionary
            lut = np.zeros(max(len(d), 1), dtype=bool)
            for v in values:
                i = int(np.searchsorted(d, v))
                if i < len(d) and d[i] == v:
                    lut[i] = True
            lut_dev = self._const(lut, torch.bool)

            def fn(env: Env) -> Value:
                codes, v = vc.fn(env)
                data = _lookup(lut_dev, codes)
                return (~data if negate else data), v

            return _C(BOOL, None, fn)

        def fn(env: Env) -> Value:
            data, v = vc.fn(env)
            acc = torch.zeros_like(data, dtype=torch.bool)
            for val in values:
                # each option is cast to the value's dtype, as numpy's astype
                # does in the JAX form
                option = np.asarray(val).astype(_numpy_dtype(data.dtype))
                acc = acc | (data == self._const(option, data.dtype))
            return (~acc if negate else acc), v

        return _C(BOOL, None, fn)

    def _like(self, e: ast.Like) -> _C:
        vc = self.compile(e.value)
        if vc.dtype is not DataType.STRING:
            raise TypeError("LIKE on non-string")
        rx = like_to_regex(e.pattern)
        d = vc.dictionary
        lut = np.array([rx.fullmatch(s) is not None for s in d], dtype=bool) \
            if len(d) else np.zeros(1, dtype=bool)
        if e.negate:
            lut = ~lut
        lut_dev = self._const(lut, torch.bool)

        def fn(env: Env) -> Value:
            codes, v = vc.fn(env)
            return _lookup(lut_dev, codes), v

        return _C(BOOL, None, fn)

    def _is_null(self, e: ast.IsNull) -> _C:
        vc = self.compile(e.value)
        negate = e.negate

        def fn(env: Env) -> Value:
            _, v = vc.fn(env)
            out = self._full(False, torch.bool) if v is None else ~v
            return (~out if negate else out), None

        return _C(BOOL, None, fn)

    def _logical(self, e: ast.Logical) -> _C:
        lc, rc = self.compile(e.left), self.compile(e.right)
        op = e.op

        def fn(env: Env) -> Value:
            (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
            ld = ld.to(torch.bool)
            rd = rd.to(torch.bool)
            data = (ld & rd) if op == "and" else (ld | rd)
            if lv is None and rv is None:
                return data, None
            lt = ld if lv is None else (ld & lv)
            rt = rd if rv is None else (rd & rv)
            lf = torch.zeros_like(ld) if lv is None else (~ld & lv)
            rf = torch.zeros_like(rd) if rv is None else (~rd & rv)
            # Kleene: AND is definite when either side is definitely false
            # or both are true; OR when either is true or both are false
            if op == "and":
                definite = lf | rf | (lt & rt)
            else:
                definite = lt | rt | (lf & rf)
            return data, definite

        return _C(BOOL, None, fn)

    def _not(self, e: ast.Not) -> _C:
        vc = self.compile(e.value)

        def fn(env: Env) -> Value:
            data, v = vc.fn(env)
            return ~data.to(torch.bool), v

        return _C(BOOL, None, fn)

    def _case(self, e: ast.Case) -> _C:
        whens = [(self.compile(c), self.compile(v)) for c, v in e.whens]
        other = self.compile(e.otherwise) if e.otherwise is not None else None
        # Result type: common type of all branches.
        branch_types = [v.dtype for _, v in whens] + \
            ([other.dtype] if other else [DataType.NULL])
        out_dt = branch_types[0]
        for t in branch_types[1:]:
            out_dt = common_numeric_type(out_dt, t) if out_dt is not DataType.STRING \
                else DataType.STRING
        if out_dt is DataType.STRING:
            return self._string_case(whens, other)

        def fn(env: Env) -> Value:
            if other is not None:
                data, valid = other.fn(env)
                data = _cast_to(data, out_dt)
            else:
                data = self._full(0, out_dt.torch_dtype)
                valid = self._full(False, torch.bool)
            # apply WHENs in reverse so earlier ones win
            for cond_c, val_c in reversed(whens):
                cd, cv = cond_c.fn(env)
                cd = cd.to(torch.bool)
                if cv is not None:
                    cd = cd & cv
                vd, vv = val_c.fn(env)
                data = torch.where(cd, _cast_to(vd, out_dt), data)
                if valid is not None or vv is not None:
                    base_v = self._full(True, torch.bool) if valid is None else valid
                    new_v = self._full(True, torch.bool) if vv is None else vv
                    valid = torch.where(cd, new_v, base_v)
            return data, valid

        return _C(out_dt, None, fn)

    def _string_case(self, whens, other) -> _C:
        """CASE with string-valued branches: merge all branch dictionaries,
        remap each branch's codes into the merged code space, where-chain."""
        branches = [v for _, v in whens] + ([other] if other is not None else [])
        for b in branches:
            if b.dtype not in (DataType.STRING, DataType.NULL):
                raise TypeError("CASE mixes string and non-string branches")
        merged = np.array([], dtype=str)
        for b in branches:
            if b.dtype is DataType.STRING:
                merged = np.unique(np.concatenate(
                    [merged.astype(str), b.dictionary.astype(str)]))

        def remap_of(b):
            if b.dtype is not DataType.STRING:
                return None
            r = np.searchsorted(merged, b.dictionary).astype(np.int32)
            return self._const(r if len(r) else np.zeros(1, np.int32), torch.int32)

        remaps = [remap_of(b) for b in branches]

        def fn(env: Env) -> Value:
            def branch_value(i):
                b = branches[i]
                d, v = b.fn(env)
                if b.dtype is DataType.STRING:
                    d = _lookup(remaps[i], d)
                return d, v

            if other is not None:
                data, valid = branch_value(len(branches) - 1)
            else:
                data = self._full(0, torch.int32)
                valid = self._full(False, torch.bool)
            for idx in range(len(whens) - 1, -1, -1):
                cd, cv = whens[idx][0].fn(env)
                cd = cd.to(torch.bool)
                if cv is not None:
                    cd = cd & cv
                vd, vv = branch_value(idx)
                data = torch.where(cd, vd, data)
                base_v = self._full(True, torch.bool) if valid is None else valid
                new_v = self._full(True, torch.bool) if vv is None else vv
                valid = torch.where(cd, new_v, base_v)
            return data, valid

        return _C(DataType.STRING, merged, fn)

    def _cast(self, e: ast.Cast) -> _C:
        vc = self.compile(e.value)
        target = e.dtype
        if target is DataType.STRING and vc.dtype in (DataType.INT32,
                                                      DataType.INT64):
            # CAST(int AS TEXT): the output dictionary depends on the DATA,
            # so the argument is evaluated now and read back to the host.
            env = make_env(self.table, e.value.columns())
            data, v = vc.fn(env)
            strs = data.cpu().numpy().astype(np.int64).astype(str)
            dictionary, codes = np.unique(strs, return_inverse=True)
            codes_dev = self._const(codes.astype(np.int32), torch.int32)

            def fn(env: Env) -> Value:
                return codes_dev, v

            return _C(DataType.STRING, dictionary, fn)
        if vc.dtype is DataType.STRING or target is DataType.STRING:
            raise NotImplementedError("string casts")

        def fn(env: Env) -> Value:
            data, v = vc.fn(env)
            return _cast_to(data, target), v

        return _C(target, None, fn)

    def _function(self, e: ast.FunctionCall) -> _C:
        name = e.name.lower()
        if name == "substr":
            vc = self.compile(e.args[0])
            if vc.dtype is not DataType.STRING:
                raise TypeError("SUBSTR on non-string")
            if not all(isinstance(a, ast.Literal) for a in e.args[1:]):
                raise NotImplementedError("SUBSTR with non-literal bounds")
            start = int(e.args[1].value)  # 1-based (SQL)
            length = int(e.args[2].value)
            d = vc.dictionary
            if len(d):
                transformed = np.array([s[start - 1:start - 1 + length] for s in d],
                                       dtype=object)
                new_dict, inverse = np.unique(transformed.astype(str),
                                              return_inverse=True)
                remap = self._const(inverse.astype(np.int32), torch.int32)
            else:
                new_dict = np.array([], dtype=str)
                remap = self._const(np.zeros(1, np.int32), torch.int32)

            def fn(env: Env) -> Value:
                codes, v = vc.fn(env)
                return _lookup(remap, codes), v

            return _C(DataType.STRING, new_dict, fn)
        if name == "concat":
            return self._concat(e.args)
        if name == "extract":
            # EXTRACT(field FROM date_col): dates are dictionary codes of
            # 'YYYY-MM-DD' strings, so the field value is a HOST rewrite of
            # the (small) dictionary followed by a device code remap.
            assert isinstance(e.args[0], ast.Literal)
            field = str(e.args[0].value).lower()
            vc = self.compile(e.args[1])
            if vc.dtype is not DataType.STRING:
                raise TypeError("EXTRACT requires a date (string) column")
            sl = {"year": slice(0, 4), "month": slice(5, 7),
                  "day": slice(8, 10)}.get(field)
            if sl is None:
                raise NotImplementedError(f"EXTRACT({field})")
            d = vc.dictionary
            vals = (np.array([int(s[sl]) for s in d], dtype=np.int64)
                    if len(d) else np.zeros(1, dtype=np.int64))
            lut = self._const(vals, torch.int64)

            def fn(env: Env) -> Value:
                codes, v = vc.fn(env)
                return _lookup(lut, codes), v

            return _C(DataType.INT64, None, fn)
        raise NotImplementedError(f"function {name}")

    def _concat(self, args) -> _C:
        """String concatenation in code space: the result dictionary is the
        (deduplicated) cross product of the operand dictionaries, bounded to
        keep the rewrite cheap; most real uses pair a column with literals."""
        compiled = [self.compile(a) for a in args]
        out = compiled[0]
        for nxt in compiled[1:]:
            out = self._concat2(out, nxt)
        return out

    def _concat2(self, lc: _C, rc: _C) -> _C:
        if lc.dtype is not DataType.STRING or rc.dtype is not DataType.STRING:
            raise TypeError("CONCAT requires string operands")
        d1 = lc.dictionary if len(lc.dictionary) else np.array([""], dtype=str)
        d2 = rc.dictionary if len(rc.dictionary) else np.array([""], dtype=str)
        if len(d1) * len(d2) > 1 << 16:
            raise NotImplementedError(
                "CONCAT of two high-cardinality string columns")
        pairs = np.array([a + b for a in d1 for b in d2], dtype=object)
        merged, inverse = np.unique(pairs.astype(str), return_inverse=True)
        remap = self._const(inverse.astype(np.int32).reshape(len(d1), len(d2)),
                            torch.int32)

        def fn(env: Env) -> Value:
            (ld, lv), (rd, rv) = lc.fn(env), rc.fn(env)
            li = ld.clamp(0, remap.shape[0] - 1)
            ri = rd.clamp(0, remap.shape[1] - 1)
            return remap[li, ri], _and_validity(lv, rv)

        return _C(DataType.STRING, merged, fn)


_NUMPY_DTYPES = {
    torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
    torch.float64: np.float64,
}


def _numpy_dtype(dtype: torch.dtype):
    return _NUMPY_DTYPES[dtype]


def _apply_cmp(cond: PredicateCondition, a, b):
    if cond is PredicateCondition.EQUALS:
        return a == b
    if cond is PredicateCondition.NOT_EQUALS:
        return a != b
    if cond is PredicateCondition.LESS_THAN:
        return a < b
    if cond is PredicateCondition.LESS_THAN_EQUALS:
        return a <= b
    if cond is PredicateCondition.GREATER_THAN:
        return a > b
    if cond is PredicateCondition.GREATER_THAN_EQUALS:
        return a >= b
    raise ValueError(cond)


def _apply_cmp_host(cond: PredicateCondition, a, b) -> bool:
    return {
        PredicateCondition.EQUALS: a == b,
        PredicateCondition.NOT_EQUALS: a != b,
        PredicateCondition.LESS_THAN: a < b,
        PredicateCondition.LESS_THAN_EQUALS: a <= b,
        PredicateCondition.GREATER_THAN: a > b,
        PredicateCondition.GREATER_THAN_EQUALS: a >= b,
    }[cond]


def compile_expression(expr: ast.Expr, table: Table) -> CompiledExpr:
    c = _Compiler(table).compile(expr)
    is_bool = c.dtype == BOOL
    return CompiledExpr(dtype=DataType.INT32 if is_bool else c.dtype,
                        dictionary=c.dictionary, required=expr.columns(),
                        fn=c.fn, is_bool=is_bool)


def make_env(table: Table, names: List[str]) -> Env:
    return {n: (table.column(n).data, table.column(n).validity) for n in names}


def evaluate(expr: ast.Expr, table: Table) -> Column:
    """Eagerly evaluate an expression over a table -> unnamed Column.

    Predicate results come back as bool tensors (dtype INT32 marker retained
    for schema purposes); dead rows hold arbitrary values — callers mask
    with table.live_mask().
    """
    ce = compile_expression(expr, table)
    data, validity = ce.fn(make_env(table, ce.required))
    return Column(name="", dtype=ce.dtype, data=data, validity=validity,
                  dictionary=ce.dictionary)

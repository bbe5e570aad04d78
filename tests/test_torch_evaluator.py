"""Expression evaluation parity: the same expressions over the same table
through hyrise_tpu's evaluate and hyrise_tpu_torch's. Integers, strings and
predicates must match exactly, floats within 1e-12 relative, NULLs in the
same rows."""

import math
import types

import numpy as np
import pytest
import torch

import hyrise_tpu.expression.ast as jax_ast
import hyrise_tpu_torch.expression.ast as torch_ast
from hyrise_tpu.expression.evaluator import evaluate as jax_evaluate
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.expression.evaluator import evaluate
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import DataType

torch.set_num_threads(1)

N = 64


def _jax_table() -> JaxTable:
    rng = np.random.default_rng(11)
    T = JaxDataType
    defs = [JaxDef("a", T.INT32), JaxDef("b", T.INT64), JaxDef("e", T.INT32, True),
            JaxDef("f", T.FLOAT32), JaxDef("d", T.FLOAT64), JaxDef("g", T.FLOAT64, True),
            JaxDef("s", T.STRING, True), JaxDef("t", T.STRING), JaxDef("dt", T.STRING)]
    arrays = [
        rng.integers(-20, 21, N).astype(np.int32),
        rng.integers(-10**12, 10**12, N).astype(np.int64),
        rng.integers(-9, 10, N).astype(np.int32),
        (rng.random(N) * 100 - 50).astype(np.float32),
        rng.random(N) * 2 - 1,
        rng.random(N),
        np.array(rng.choice(["apple", "banana", "cherry", "date", None], N), dtype=object),
        np.array(rng.choice(["banana", "kiwi", "apple", "zebra"], N), dtype=object),
        np.array(rng.choice(["1994-03-15", "1995-12-01", "1998-07-30"], N), dtype=object),
    ]
    validities = [None, None, rng.random(N) < 0.8, None, None, rng.random(N) < 0.7,
                  None, None, None]
    return JaxTable.from_arrays("t", defs, arrays, validities)


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return table_from_numpy("t", cols, jt.num_rows, device="cpu")


_tables = {}


def _tables_once():
    if not _tables:
        jt = _jax_table()
        _tables["jax"], _tables["torch"] = jt, _port_table(jt)
    return _tables["jax"], _tables["torch"]


def _ns(ast_mod, dtype_cls):
    return types.SimpleNamespace(col=ast_mod.col, lit=ast_mod.lit, A=ast_mod, T=dtype_cls)


# Each entry builds one expression from a namespace of col/lit/ast/DataType,
# so the same text builds a JAX tree and a port tree.
CORPUS = {
    "add_int32_int64": lambda E: E.col("a") + E.col("b"),
    "sub_nulls": lambda E: E.col("a") - E.col("e"),
    "mul_int_float": lambda E: E.col("a") * E.col("f"),
    "div_int_trunc_neg_zero_null": lambda E: E.col("a") / E.col("e"),
    "mod_int_neg_zero_null": lambda E: E.col("a") % E.col("e"),
    "div_int64_int32": lambda E: E.col("b") / E.col("a"),
    "mod_int64_lit": lambda E: E.col("b") % E.lit(7),
    "div_lit_neg": lambda E: E.lit(-7) / E.col("a"),
    "mod_lit_neg": lambda E: E.lit(-7) % E.col("a"),
    "div_float": lambda E: E.col("f") / E.col("d"),
    "div_float_by_zero": lambda E: E.col("f") / (E.col("d") - E.col("d")),
    "mod_float": lambda E: E.col("d") % E.lit(0.3),
    "int_plus_null_float": lambda E: E.col("e") + E.col("g"),
    "neg": lambda E: -E.col("a"),
    "int64_literal": lambda E: E.col("b") * E.lit(3_000_000_000),
    "null_literal_plus": lambda E: E.lit(None) + E.col("a"),
    "lt_int_lit": lambda E: E.col("a") < E.lit(3),
    "ge_float_int_lit": lambda E: E.col("f") >= E.lit(10),
    "eq_int_float_lit": lambda E: E.col("a") == E.lit(2.5),
    "gt_int64_int32": lambda E: E.col("b") > E.col("a"),
    "lt_f32_f64": lambda E: E.col("f") < E.col("d"),
    "le_int_f32": lambda E: E.col("a") <= E.col("f"),
    "lit_left": lambda E: E.lit(5) > E.col("a"),
    "eq_null_literal": lambda E: E.col("a") == E.lit(None),
    "str_eq": lambda E: E.col("s") == E.lit("banana"),
    "str_eq_absent": lambda E: E.col("s") == E.lit("fig"),
    "str_ne_absent": lambda E: E.col("s") != E.lit("fig"),
    "str_lt": lambda E: E.col("s") < E.lit("c"),
    "str_lit_left": lambda E: E.lit("b") <= E.col("s"),
    "str_gt": lambda E: E.col("t") > E.lit("banana"),
    "str_two_dicts": lambda E: E.col("s") >= E.col("t"),
    "str_same_col": lambda E: E.col("s") == E.col("s"),
    "str_literals": lambda E: E.lit("a") < E.lit("b"),
    "between_int": lambda E: E.col("a").between(-5, 5),
    "between_cols": lambda E: E.col("d").between(E.lit(-0.5), E.col("g")),
    "between_str": lambda E: E.col("dt").between("1995-01-01", "1998-12-31"),
    "in_int": lambda E: E.col("a").isin([1, 2, 3, -4]),
    "not_in_int": lambda E: E.col("a").notin([0, -1]),
    "in_float_col_int_opts": lambda E: E.col("f").isin([1, 2.5]),
    "in_str": lambda E: E.col("s").isin(["apple", "zebra"]),
    "not_in_str": lambda E: E.col("s").notin(["apple"]),
    "like": lambda E: E.col("s").like("%an%"),
    "not_like": lambda E: E.col("s").not_like("a%"),
    "like_underscore": lambda E: E.col("t").like("_iwi"),
    "is_null": lambda E: E.col("e").is_null(),
    "is_not_null_str": lambda E: E.col("s").is_not_null(),
    "is_null_no_validity": lambda E: E.col("a").is_null(),
    "and_kleene": lambda E: (E.col("a") > 0) & (E.col("e") > 0),
    "or_kleene": lambda E: (E.col("a") > 0) | (E.col("e") < 0),
    "not_null": lambda E: ~(E.col("e") > 0),
    "nested_logic": lambda E: ((E.col("e") > 0) & (E.col("g") > 0.5)) | (E.col("s") == "apple"),
    "case_numeric": lambda E: E.A.Case([(E.col("a") > 0, E.lit(1)),
                                        (E.col("a") < -5, E.lit(2))], E.lit(0)),
    "case_null_else": lambda E: E.A.Case([(E.col("e") > 0, E.col("f"))]),
    "case_mixed_types": lambda E: E.A.Case([(E.col("g") > 0.5, E.col("b"))], E.col("d")),
    "case_string": lambda E: E.A.Case([(E.col("a") > 0, E.col("s"))], E.col("t")),
    "case_string_null_else": lambda E: E.A.Case([(E.col("a") > 0, E.lit("pos"))]),
    "cast_int_to_f64": lambda E: E.col("a").cast(E.T.FLOAT64),
    "cast_float_to_int": lambda E: E.col("f").cast(E.T.INT32),
    "cast_int64_to_int32_nulls": lambda E: E.col("e").cast(E.T.INT64),
    "cast_int_to_string": lambda E: E.col("a").cast(E.T.STRING),
    "substr": lambda E: E.col("s").substr(1, 2),
    "concat": lambda E: E.A.FunctionCall("concat", [E.col("s"), E.lit("-x")]),
    "extract_year": lambda E: E.A.FunctionCall("extract", [E.lit("year"), E.col("dt")]),
    "extract_month": lambda E: E.A.FunctionCall("extract", [E.lit("month"), E.col("dt")]),
}


# ROADMAP C16: the JAX package casts a fractional literal to an integral
# column's type (`a = 2.5` becomes `a = 2`); the port compares exactly, as
# sqlite does, so these cases are held against numpy's exact comparison of
# the same column instead.
C16_EXACT = {"eq_int_float_lit": lambda jt: np.asarray(jt.column("a").data)[:N] == 2.5}


def _same(got, want, floating: bool) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if floating:
        g, w = float(got), float(want)
        if math.isnan(w) or math.isinf(w):
            return (math.isnan(g) and math.isnan(w)) or g == w
        return math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0)
    if isinstance(want, str):
        return got == want
    return int(got) == int(want)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_expression_matches_jax(name):
    jt, pt = _tables_once()
    build = CORPUS[name]
    jc = jax_evaluate(build(_ns(jax_ast, JaxDataType)), jt)
    pc = evaluate(build(_ns(torch_ast, DataType)), pt)
    assert pc.dtype.value == jc.dtype.value
    assert pc.data.device.type == "cpu"
    if jc.dictionary is not None:
        np.testing.assert_array_equal(pc.dictionary, jc.dictionary)
    got, want = pc.decode(N), jc.decode(N)
    if name in C16_EXACT:
        want = C16_EXACT[name](jt)
    floating = pc.dtype.is_floating
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w, floating)]
    assert not bad, bad[:5]

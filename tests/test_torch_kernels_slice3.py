"""The plain versions of the K6-K9 kernels (hyrise_tpu_torch.kernels:
fused_reduce, segment_reduce, hash_lookup, compact) and the
FusedFilterAggregate operator against the JAX package on the same numpy
inputs, run on the CPU as the JAX package's own tests run them (both
formulations of tpu_prims via HYRISE_TPU_FASTPATH). Integers, positions, row
ids and flags must match exactly; float64 sums within 1e-12 relative
(another summation order). The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.expression import ast as jax_ast
from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.kernels.fused import FusedFilterAggregate as JaxFused
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.ops.get_table import TableWrapper as JaxTableWrapper
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import AggregateFunction as JaxAgg
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.kernels import (compact, fused_reduce, hash_lookup, prims,
                                      segment_reduce)
from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import AggregateFunction

torch.set_num_threads(1)


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


VALUE_MAKERS = {
    "float64": lambda rng, n: rng.random(n) * 1e4 - 3e3,
    "float32": lambda rng, n: (rng.random(n) * 100).astype(np.float32),
    "int64": lambda rng, n: rng.integers(-10**12, 10**12, n),
    "int32": lambda rng, n: rng.integers(-10**6, 10**6, n).astype(np.int32),
}


# -- K9 compact_indices --------------------------------------------------------------


@pytest.mark.parametrize("share", [0.0, 0.02, 0.5, 0.98, 1.0])
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4099])
def test_compact_indices_matches_jax(n, share, fastpath):
    mask = np.random.default_rng(n + 1).random(n) < share
    before = prims.compact_indices.launches
    got = prims.compact_indices(_t(mask))
    assert prims.compact_indices.launches == before  # CPU: no kernel
    assert got.dtype == torch.int64
    count = int(mask.sum())
    want = np.asarray(tpu_prims.compact_indices(jnp.asarray(mask), max(n, 1)))[:count]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(mask))


def test_compact_indices_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        compact.compact_indices_plain(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        compact.compact_indices_plain(torch.zeros((2, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        compact.compact_indices(torch.zeros(4, dtype=torch.bool, device="meta"))


# -- K7 segment_reduce_sorted --------------------------------------------------------


def _segments(rng, n, n_groups):
    """starts of n_groups groups over n rows (some empty), a permutation and
    a validity column."""
    cuts = np.sort(rng.integers(0, n + 1, max(n_groups - 1, 0)))
    starts = np.concatenate([[0], cuts, [n]]).astype(np.int64) if n_groups \
        else np.zeros(1, dtype=np.int64)
    return starts, rng.permutation(n).astype(np.int64), rng.random(n) < 0.7


def _segment_oracle(values, starts, kind, rows, validity):
    out, counts = [], []
    for g in range(len(starts) - 1):
        idx = np.arange(starts[g], starts[g + 1])
        if rows is not None:
            idx = rows[idx]
        if validity is not None:
            idx = idx[validity[idx]]
        counts.append(len(idx))
        if kind == "count":
            out.append(len(idx))
        elif kind == "sum":
            acc = 0.0 if values.dtype.kind == "f" else 0
            for v in values[idx]:  # in row order
                acc = acc + (float(v) if values.dtype.kind == "f" else int(v))
            out.append(acc)
        else:
            if len(idx) == 0:
                lim = np.finfo(values.dtype) if values.dtype.kind == "f" \
                    else np.iinfo(values.dtype)
                empty = (np.inf if kind == "min" else -np.inf) \
                    if values.dtype.kind == "f" else (lim.max if kind == "min" else lim.min)
                out.append(empty)
            else:
                out.append(values[idx].min() if kind == "min" else values[idx].max())
    return np.array(out), np.array(counts, dtype=np.int64)


@pytest.mark.parametrize("with_rows,with_validity", [(False, False), (True, False),
                                                     (True, True), (False, True)])
@pytest.mark.parametrize("n,n_groups", [(0, 0), (1, 1), (1000, 1), (1000, 37),
                                        (4099, 1500)])
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_sorted_sum_matches_jax(dtype, n, n_groups, with_rows,
                                               with_validity, fastpath):
    rng = np.random.default_rng(n * 7 + n_groups)
    values = VALUE_MAKERS[dtype](rng, n)
    starts, rows, validity = _segments(rng, n, n_groups)
    rows = rows if with_rows else None
    validity = validity if with_validity else None
    before = prims.segment_reduce_sorted.launches
    got, n_valid = prims.segment_reduce_sorted(
        _t(values), _t(starts), "sum", None if rows is None else _t(rows),
        None if validity is None else _t(validity))
    assert prims.segment_reduce_sorted.launches == before  # CPU: no kernel
    is_float = values.dtype.kind == "f"
    assert got.dtype == (torch.float64 if is_float else torch.int64)
    want, want_counts = _segment_oracle(values, starts, "sum", rows, validity)
    np.testing.assert_array_equal(n_valid.numpy(), want_counts)
    if n_groups:
        # the JAX form takes the values already gathered into group order,
        # NULL inputs as zeros
        d = values if rows is None else values[rows]
        v = np.ones(n, dtype=bool) if validity is None else \
            (validity if rows is None else validity[rows])
        acc = np.float64 if is_float else np.int64
        gid = np.repeat(np.arange(n_groups), np.diff(starts))
        jax_sums = np.asarray(tpu_prims.segment_sums_sorted(
            jnp.asarray(np.where(v, d, 0).astype(acc)), jnp.asarray(starts[:-1]),
            jnp.asarray(np.diff(starts)), n, gid=jnp.asarray(gid)))
        if is_float:
            np.testing.assert_allclose(got.numpy(), jax_sums, rtol=1e-12, atol=1e-9)
        else:
            np.testing.assert_array_equal(got.numpy(), jax_sums)
    if is_float:
        np.testing.assert_allclose(got.numpy(), want.astype(np.float64), rtol=1e-12,
                                   atol=1e-9)
    else:
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("kind", ["min", "max", "count"])
@pytest.mark.parametrize("n,n_groups", [(0, 0), (1, 1), (1000, 37), (4099, 1500)])
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_sorted_extrema_and_counts(dtype, n, n_groups, kind):
    rng = np.random.default_rng(n * 11 + n_groups)
    values = VALUE_MAKERS[dtype](rng, n)
    starts, rows, validity = _segments(rng, n, n_groups)
    got, n_valid = prims.segment_reduce_sorted(
        None if kind == "count" else _t(values), _t(starts), kind, _t(rows),
        _t(validity))
    want, want_counts = _segment_oracle(values, starts, kind, rows, validity)
    np.testing.assert_array_equal(n_valid.numpy(), want_counts)
    if kind != "count":
        assert got.dtype == _t(values).dtype  # exact in the input's type
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_segment_reduce_sorted_rejects_what_the_kernel_does_not_take():
    values, starts = torch.zeros(4), torch.tensor([0, 4])
    with pytest.raises(ValueError):
        segment_reduce.segment_reduce_sorted(values.double(), starts, "mean")
    with pytest.raises(TypeError):
        segment_reduce.segment_reduce_sorted(values.double(), starts.int(), "sum")
    with pytest.raises(TypeError):
        segment_reduce.segment_reduce_sorted(values.half(), starts, "sum")
    with pytest.raises(TypeError):
        segment_reduce.segment_reduce_sorted(None, starts, "sum")
    with pytest.raises(TypeError):
        segment_reduce.segment_reduce_sorted(values.double(), starts, "sum",
                                             torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        segment_reduce.segment_reduce_sorted(values.double(), starts, "sum", None,
                                             torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        segment_reduce.segment_reduce_sorted(values.double().to("meta"),
                                             starts.to("meta"), "sum")


# -- K8 lookup_last_eq ---------------------------------------------------------------


def _lookup_oracle(bk, bvalid, pk):
    matched = np.zeros(len(pk), dtype=bool)
    row = np.zeros(len(pk), dtype=np.int64)
    for i, k in enumerate(pk):
        hits = [j for j in range(len(bk)) if bvalid[j] and bk[j] == k]
        if hits:
            matched[i], row[i] = True, hits[-1]
    return matched, row


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("nb,nq,span", [(50, 300, 20), (1, 1, 1), (0, 20, 5), (200, 0, 5),
                                        (300, 300, 10**15)])
def test_lookup_last_eq_matches_jax(nb, nq, span, dtype, fastpath):
    rng = np.random.default_rng(nb * 7 + nq)
    bk = rng.integers(-span, span, nb).astype(dtype)      # duplicates at a small span
    pk = np.concatenate([rng.integers(-span, span, nq // 2),
                         rng.choice(bk, nq - nq // 2) if nb else
                         rng.integers(-span, span, nq - nq // 2)]).astype(dtype)
    bvalid = rng.random(nb) < 0.8                           # invalid build rows
    before = prims.lookup_last_eq.launches
    matched, row = prims.lookup_last_eq(_t(bk), _t(bvalid), _t(pk))
    assert prims.lookup_last_eq.launches == before  # CPU: no kernel
    assert row.dtype == torch.int64 and matched.dtype == torch.bool
    if nb:  # the JAX form cannot take from an empty build side
        jm, jr = tpu_prims.lookup_last_eq(jnp.asarray(bk), jnp.asarray(bvalid),
                                          jnp.asarray(pk))
        np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    om, orow = _lookup_oracle(bk, bvalid, pk)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)


def test_lookup_last_eq_float_keys_compare_by_value(fastpath):
    """-0.0 and 0.0 are one key; the extreme values are ordinary keys. The
    JAX form agrees on all of these."""
    bk = np.array([0.0, 1.5, -0.0, np.inf, -np.inf, 2.5, np.finfo(np.float64).max])
    bvalid = np.array([True, True, True, True, True, False, True])
    pk = np.array([-0.0, 0.0, 1.5, 2.5, np.inf, -np.inf, np.finfo(np.float64).max, 7.0])
    matched, row = prims.lookup_last_eq(_t(bk), _t(bvalid), _t(pk))
    om, orow = _lookup_oracle(bk, bvalid, pk)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)
    assert row[:2].tolist() == [2, 2]  # the LAST zero, whatever its sign
    jm, jr = tpu_prims.lookup_last_eq(jnp.asarray(bk), jnp.asarray(bvalid),
                                      jnp.asarray(pk))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))


def test_lookup_last_eq_nan_matches_nothing():
    """A NaN equals nothing, itself included: neither a NaN build key nor a
    NaN probe key matches (SQL's and IEEE's equality)."""
    bk = np.array([np.nan, 1.0, np.nan, 3.0])
    pk = np.array([np.nan, 1.0, 3.0, 2.0])
    matched, row = prims.lookup_last_eq(_t(bk), _t(np.ones(4, dtype=bool)), _t(pk))
    assert matched.tolist() == [False, True, True, False]
    assert row.tolist() == [0, 1, 3, 0]


def test_lookup_last_eq_extreme_integer_keys():
    """INT64_MIN is the hash table's empty-slot pattern: it is still a key."""
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    bk = np.array([lo, 5, hi, lo, 5], dtype=np.int64)
    bvalid = np.array([True, True, True, True, False])
    pk = np.array([lo, hi, 5, 0, lo + 1], dtype=np.int64)
    matched, row = prims.lookup_last_eq(_t(bk), _t(bvalid), _t(pk))
    assert matched.tolist() == [True, True, True, False, False]
    assert row.tolist() == [3, 2, 1, 0, 0]


def test_lookup_last_eq_rejects_what_the_kernel_does_not_take():
    bk, bv, pk = torch.arange(4), torch.ones(4, dtype=torch.bool), torch.arange(3)
    with pytest.raises(TypeError):
        hash_lookup.lookup_last_eq(bk.int(), bv, pk.int())
    with pytest.raises(TypeError):
        hash_lookup.lookup_last_eq(bk, bv, pk.double())
    with pytest.raises(TypeError):
        hash_lookup.lookup_last_eq(bk, bv.to(torch.uint8), pk)
    with pytest.raises(ValueError):
        hash_lookup.lookup_last_eq(bk, bv[:2], pk)
    with pytest.raises(ValueError):
        hash_lookup.lookup_last_eq(bk.to("meta"), bv.to("meta"), pk.to("meta"))


# -- K6 fused_cells_reduce and FusedFilterAggregate ------------------------------------

N = 600


def _fused_jax_table(rng, masked: bool, all_null_group: bool = False) -> JaxTable:
    T = JaxDataType
    defs = [JaxDef("flag", T.STRING), JaxDef("status", T.STRING),
            JaxDef("wide", T.STRING), JaxDef("ns", T.STRING, True),
            JaxDef("k", T.INT32), JaxDef("qty", T.FLOAT32),
            JaxDef("price", T.FLOAT32), JaxDef("disc", T.FLOAT32),
            JaxDef("d", T.FLOAT64, True), JaxDef("i", T.INT32, True),
            JaxDef("big", T.INT64), JaxDef("ship", T.INT32)]
    flag = np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, N)]
    d_valid = rng.random(N) < 0.7
    if all_null_group:
        d_valid &= flag != "N"  # every d of the N groups is NULL
    arrays = [flag,
              np.array(["F", "O"], dtype=object)[rng.integers(0, 2, N)],
              np.array([f"w{j:03d}" for j in rng.integers(0, 90, N)], dtype=object),
              np.array(["x", "y"], dtype=object)[rng.integers(0, 2, N)],
              rng.integers(0, 5, N).astype(np.int32),
              rng.integers(1, 51, N).astype(np.float32),
              (rng.random(N) * 1e5).astype(np.float32),
              (rng.integers(0, 11, N) / 100).astype(np.float32),
              rng.random(N) * 1e3 - 500,
              rng.integers(-1000, 1000, N).astype(np.int32),
              rng.integers(-2**50, 2**50, N),
              rng.integers(8000, 10500, N).astype(np.int32)]
    validities = [None, None, None, rng.random(N) < 0.8, None, None, None, None,
                  d_valid, rng.random(N) < 0.6, None, None]
    t = JaxTable.from_arrays("t", defs, arrays, validities)
    if masked:
        live = np.zeros(t.capacity, dtype=bool)
        live[:N] = rng.random(N) < 0.6
        t = JaxTable(t.columns, int(live.sum()), name="t", live=jnp.asarray(live))
    return t


def _port_table(jt: JaxTable):
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    live = None if jt.live is None else np.asarray(jt.live)
    return table_from_numpy("t", cols, jt.num_rows, live, device="cpu")


def _same(got, want) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, str):
        return got == want
    if isinstance(want, (float, np.floating)):
        g, w = float(got), float(want)
        return math.isnan(g) if math.isnan(w) else math.isclose(g, w, rel_tol=1e-9,
                                                               abs_tol=0.0)
    return int(got) == int(want)


def _assert_rows_equal(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        assert all(_same(a, b) for a, b in zip(g, w)), (i, g, w)


def _aggs(A, fn_enum, specs):
    return [(name, A.AggregateExpr(getattr(fn_enum, fn), arg)) for name, fn, arg in specs]


def _q1_like(A, fn_enum):
    c, lit = A.col, A.lit
    disc_price = c("price") * (lit(1.0) - c("disc"))
    return (c("ship") <= lit(10000),
            ["flag", "status"],
            _aggs(A, fn_enum, [("sum_qty", "SUM", c("qty")),
                               ("sum_base", "SUM", c("price")),
                               ("sum_disc", "SUM", disc_price),
                               ("avg_qty", "AVG", c("qty")),
                               ("avg_price", "AVG", c("price")),
                               ("avg_disc", "AVG", c("disc")),
                               ("n", "COUNT", None)]))


def _q6_like(A, fn_enum):
    c, lit = A.col, A.lit
    pred = (c("ship") >= lit(8500)) & (c("ship") < lit(9500)) & (c("qty") < lit(24.0))
    return pred, [], _aggs(A, fn_enum, [("revenue", "SUM", c("price") * c("disc"))])


def _nullable(A, fn_enum):
    c, lit = A.col, A.lit
    return (c("k") > lit(0),
            ["flag"],
            _aggs(A, fn_enum, [("sd", "SUM", c("d")), ("ad", "AVG", c("d")),
                               ("mind", "MIN", c("d")), ("maxd", "MAX", c("d")),
                               ("cd", "COUNT", c("d")), ("si", "SUM", c("i")),
                               ("mini", "MIN", c("i")), ("maxi", "MAX", c("i")),
                               ("ci", "COUNT", c("i")), ("sb", "SUM", c("big")),
                               ("minb", "MIN", c("big")), ("maxb", "MAX", c("big")),
                               ("n", "COUNT", None)]))


def _no_predicate(A, fn_enum):
    c = A.col
    return None, ["status"], _aggs(A, fn_enum, [("s", "SUM", c("qty")),
                                                ("n", "COUNT", None)])


def _nothing_passes(A, fn_enum):
    c, lit = A.col, A.lit
    return (c("ship") > lit(99999), [],
            _aggs(A, fn_enum, [("s", "SUM", c("qty")), ("m", "MIN", c("i")),
                               ("n", "COUNT", None)]))


FUSED_SHAPES = {"q1": _q1_like, "q6": _q6_like, "nullable": _nullable,
                "no_predicate": _no_predicate, "nothing_passes": _nothing_passes}


def _run_fused_both(jt, shape):
    pred, groupby, aggs = shape(ast, AggregateFunction)
    op = FusedFilterAggregate(TableWrapper(_port_table(jt)), pred, groupby, aggs)
    got = execute_plan(op)
    jpred, _, jaggs = shape(jax_ast, JaxAgg)
    want = jax_execute_plan(JaxFused(JaxTableWrapper(jt), jpred, groupby, jaggs))
    return op, got, want


@pytest.mark.parametrize("masked", [False, True], ids=["prefix", "masked"])
@pytest.mark.parametrize("shape", sorted(FUSED_SHAPES))
def test_fused_filter_aggregate_matches_jax(shape, masked, fastpath):
    jt = _fused_jax_table(np.random.default_rng(17), masked)
    before = fused_reduce.fused_cells_reduce.launches
    op, got, want = _run_fused_both(jt, FUSED_SHAPES[shape])
    assert fused_reduce.fused_cells_reduce.launches == before  # CPU: no kernel
    assert op.fell_back is False
    assert got.column_names == want.column_names
    assert [c.dtype.value for c in got.columns] == [c.dtype.value for c in want.columns]
    _assert_rows_equal(got.rows(), want.rows())


def test_fused_all_null_group_gives_null_not_zero(fastpath):
    jt = _fused_jax_table(np.random.default_rng(23), False, all_null_group=True)
    op, got, want = _run_fused_both(jt, _nullable)
    assert op.fell_back is False
    _assert_rows_equal(got.rows(), want.rows())
    n_row = [r for r in got.rows() if r[0] == "N"][0]
    assert n_row[1] is None and n_row[3] is None and n_row[5] == 0  # SUM, MIN NULL; COUNT 0


def _fallback_cases(A, fn_enum):
    c, lit = A.col, A.lit
    pred = c("ship") <= lit(10000)
    count = _aggs(A, fn_enum, [("n", "COUNT", None), ("s", "SUM", c("qty"))])
    return {
        "non_dictionary_key": (pred, ["k"], count),
        "nullable_key": (pred, ["ns"], count),
        "count_distinct": (pred, ["flag"],
                           _aggs(A, fn_enum, [("u", "COUNT_DISTINCT", c("k"))])),
        "string_min": (pred, ["flag"], _aggs(A, fn_enum, [("m", "MIN", c("status"))])),
    }


@pytest.mark.parametrize("case", ["non_dictionary_key", "nullable_key", "count_distinct",
                                  "string_min"])
def test_fused_fallback_conditions_match_jax(case):
    jt = _fused_jax_table(np.random.default_rng(29), False)
    pred, groupby, aggs = _fallback_cases(ast, AggregateFunction)[case]
    op = FusedFilterAggregate(TableWrapper(_port_table(jt)), pred, groupby, aggs)
    got = execute_plan(op)
    assert op.fell_back is True
    jpred, _, jaggs = _fallback_cases(jax_ast, JaxAgg)[case]
    want = jax_execute_plan(JaxFused(JaxTableWrapper(jt), jpred, groupby, jaggs))
    assert got.column_names == want.column_names
    _assert_rows_equal(got.rows(), want.rows())


def test_fused_more_cells_than_the_dense_form_takes_falls_back():
    """90 x 3 cells: the JAX form switches to segment_sum, the port to the
    general group-by; the rows agree."""
    jt = _fused_jax_table(np.random.default_rng(31), True)

    def shape(A, fn_enum):
        c, lit = A.col, A.lit
        return (c("ship") <= lit(10000), ["wide", "flag"],
                _aggs(A, fn_enum, [("s", "SUM", c("price")), ("m", "MAX", c("i")),
                                   ("n", "COUNT", None)]))
    op, got, want = _run_fused_both(jt, shape)
    assert op.fell_back is True
    _assert_rows_equal(got.rows(), want.rows())


def test_fused_integer_extrema_are_exact_where_the_jax_form_rounds():
    """The JAX form folds MIN/MAX of every type in float64; the port keeps
    integers in int64. Below 2**53 both agree (the cases above); above it
    the port returns the exact value."""
    big = np.array([2**60 + 1, 2**60 + 3, 5], dtype=np.int64)
    t = table_from_numpy("t", [("g", "string", np.zeros(3, dtype=np.int32), None,
                               np.array(["a"], dtype=object)),
                              ("big", "int64", big, None, None)], 3, device="cpu")
    op = FusedFilterAggregate(TableWrapper(t), None, ["g"], _aggs(
        ast, AggregateFunction, [("hi", "MAX", ast.col("big")),
                                 ("lo", "MIN", ast.col("big"))]))
    assert execute_plan(op).rows() == [("a", 2**60 + 3, 5)]


@pytest.mark.parametrize("n_cells_shape", [[], [1], [3, 2], [4, 4, 4]])
@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_fused_cells_reduce_plain_matches_a_numpy_oracle(n, n_cells_shape):
    """The wrapper's plain version at the wrapper's own interface (mixed
    input types, shared and separate validity columns, counts), cell by
    cell; the operator tests above hold it to the JAX `compute`."""
    rng = np.random.default_rng(n + len(n_cells_shape))
    mask = rng.random(n) < 0.7
    keys = [rng.integers(0, size, n).astype(np.int32) for size in n_cells_shape]
    f32 = VALUE_MAKERS["float32"](rng, n)
    i32 = VALUE_MAKERS["int32"](rng, n)
    f64 = VALUE_MAKERS["float64"](rng, n)
    valid = rng.random(n) < 0.6
    slots = [(f32, None, "sum"), (i32, valid, "sum"), (f64, valid, "min"),
             (i32, None, "max"), (None, valid, "count"), (None, None, "count")]
    counts, results = fused_reduce.fused_cells_reduce(
        _t(mask), [_t(k) for k in keys], n_cells_shape,
        [(None if v is None else _t(v), None if m is None else _t(m), kind)
         for v, m, kind in slots])
    n_cells = int(np.prod(n_cells_shape)) if n_cells_shape else 1
    cell = np.zeros(n, dtype=np.int64)
    for k, size in zip(keys, n_cells_shape):
        cell = cell * size + k
    for c in range(n_cells):
        rows = mask & (cell == c)
        assert int(counts[c]) == int(rows.sum())
        for (values, m, kind), (r, n_valid) in zip(slots, results):
            sel = rows if m is None else rows & m
            assert int(n_valid[c]) == int(sel.sum())
            if kind == "count":
                assert int(r[c]) == int(sel.sum())
            elif kind == "sum" and values.dtype.kind == "f":
                assert math.isclose(float(r[c]), float(values[sel].astype(np.float64).sum()),
                                    rel_tol=1e-12, abs_tol=1e-9)
            elif kind == "sum":
                assert int(r[c]) == int(values[sel].astype(np.int64).sum())
            elif sel.any():
                assert r[c].item() == (values[sel].min() if kind == "min"
                                       else values[sel].max())


# A launch's shape (fused_reduce.launch_shape, here at 4 rows a thread, tiles
# of 1,024 rows): 1,280 bytes of the job, two stages of every column (1,024
# rows, 16 bytes more each), 8 bytes an accumulator entry for each of the 8
# warps (up to 8 cells) or of 128, 64 or 32 folders (9 to 64 cells), 1,024
# cell bytes, a 16-byte flag and 16 bytes of barriers; the first that leaves
# room for two blocks an SM (115,712 bytes), else the smallest.
@pytest.mark.parametrize("n_cells,items,fixed,want", [
    # Q1: 6 cells, mask and two code columns, row count + 5 float32 sums:
    # 1,280 + 2 x (1,040 + 7 x 4,112) + 36 x 64 + 1,024 + 32
    (6, [(4, -1)] * 5, [1, 4, 4], [(64288, [0, 1, 2, 3, 4])]),
    # 64 cells x 8 float64 sums: 32 folders, split 5 + 3
    (64, [(8, -1)] * 8, [1, 4, 4], [(201248, [0, 1, 2, 3, 4]), (135648, [5, 6, 7])]),
    # 64 cells, 16 nullable inputs: each launch with its own validity counts
    (64, [(8, v) for v in range(16)], [1, 4, 4],
     [(191040, [0, 1, 2]), (191040, [3, 4, 5]), (191040, [6, 7, 8]),
      (191040, [9, 10, 11]), (191040, [12, 13, 14]), (88512, [15])]),
    # more folds than the kernel's 16 slots
    (4, [(4, -1)] * 20, [1, 4], [(148576, list(range(16))), (46816, [16, 17, 18, 19])]),
    # a bare row count
    (1, [], [1], [(4480, [])]),
    # a validity column of which only the count is wanted
    (2, [(4, 0), (0, 1)], [1, 4], [(25536, [0, 1])]),
])
def test_fused_launch_plan(n_cells, items, fixed, want):
    assert fused_reduce.plan_launches(n_cells, items, fixed) == want
    for shared, members in want:
        used = {items[m][1] for m in members if items[m][1] >= 0}
        values = [items[m][0] for m in members if items[m][0]]
        assert len(values) <= fused_reduce.MAX_SLOTS
        assert shared <= fused_reduce.SHARED_BYTES
        assert shared == fused_reduce.launch_shape(
            [*fixed, *[1] * len(used), *values], 1 + len(used) + len(values), n_cells,
            (4,))[2]


def test_fused_cells_reduce_rejects_what_the_kernel_does_not_take():
    mask = torch.ones(4, dtype=torch.bool)
    key = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_reduce.fused_cells_reduce(mask, [key], [65], [])
    with pytest.raises(ValueError):
        fused_reduce.fused_cells_reduce(mask, [key] * 9, [1] * 9, [])
    with pytest.raises(TypeError):
        fused_reduce.fused_cells_reduce(mask, [key.long()], [2], [])
    with pytest.raises(TypeError):
        fused_reduce.fused_cells_reduce(mask, [key], [2], [(key.half(), None, "sum")])
    with pytest.raises(ValueError):
        fused_reduce.fused_cells_reduce(mask, [key], [2], [(key, None, "mean")])
    with pytest.raises(ValueError):
        fused_reduce.fused_cells_reduce(mask, [key], [2], [(key[:3], None, "sum")])
    with pytest.raises(ValueError):
        fused_reduce.fused_cells_reduce(mask.to("meta"), [key.to("meta")], [2], [])

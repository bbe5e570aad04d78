"""K6 (fused_cells_reduce), redesigned on the dense-cell engine of
csrc/cells_reduce.cuh, and K3 (segment_reduce_cells), whose grid-stride
kernel stays, at the edge shapes of that engine, on the CPU.

The plain versions, which the CPU takes and which chip_smoke.py holds the
kernels against on the card, are held against the JAX package on the same
numpy inputs (tpu_prims.segment_reduce_cells and FusedFilterAggregate, both
formulations via HYRISE_TPU_FASTPATH): row counts at a tile's size -1 / +0 /
+1 (tiles of 1,024 and 2,048 rows) and over many tiles, every cell-count
bucket's edges (1, 2, 8, 9, 63, 64), the four input types and the four
folds, NaN and +-inf in min and max, columns one element into their
buffers. Integers and min/max must match exactly (NaN where NaN), float64
sums within 1e-12 relative (another summation order). Then the host-side
functions that pick a launch's tile, folders and blocks."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.kernels.fused import FusedFilterAggregate as JaxFused
from hyrise_tpu.ops.base import execute_plan as jax_execute_plan
from hyrise_tpu.ops.get_table import TableWrapper as JaxTableWrapper
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.storage.table import TableColumnDefinition as JaxDef
from hyrise_tpu.types import AggregateFunction as JaxAgg
from hyrise_tpu.types import DataType as JaxDataType
from hyrise_tpu_torch.expression import ast
from hyrise_tpu_torch.kernels import build, fused_reduce, group_reduce
from hyrise_tpu_torch.kernels.fused import FusedFilterAggregate
from hyrise_tpu_torch.ops.base import execute_plan
from hyrise_tpu_torch.ops.get_table import TableWrapper
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.types import AggregateFunction

torch.set_num_threads(1)

EDGE_ROWS = [1023, 1024, 1025, 2047, 2048, 2049, 9 * 2048 + 7]
EDGE_CELLS = [1, 2, 8, 9, 63, 64]


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _values(rng, n):
    """The four input types, and a float64 / float32 column with NaN, +inf
    and -inf planted for min and max."""
    vals = {
        "float64": rng.random(n) * 1e4 - 3e3,
        "float32": (rng.random(n) * 100).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    special = {}
    for name in ("float64", "float32"):
        v = vals[name].copy()
        at = rng.permutation(n)[:3]
        v[at] = np.array([np.nan, np.inf, -np.inf], dtype=v.dtype)[:len(at)]
        special[name] = v
    return vals, special


def _view(a):
    """A torch tensor one element into a buffer of len(a) + 1."""
    buf = np.concatenate([a[:1], a]) if len(a) else np.zeros(1, dtype=a.dtype)
    return torch.as_tensor(buf)[1:]


def _assert_same(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


# -- K3: segment_reduce_cells_plain against tpu_prims -------------------------------


@pytest.mark.parametrize("n_cells", EDGE_CELLS)
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_segment_reduce_cells_edges_match_jax(n, n_cells, fastpath):
    rng = np.random.default_rng(n * 67 + n_cells)
    vals, special = _values(rng, n)
    cell = rng.integers(-1, n_cells + 2, n).astype(np.int32)  # some rows outside
    cell_t = _view(cell)
    want = np.asarray(tpu_prims.segment_reduce_cells(
        jnp.ones(n, dtype=jnp.int64), jnp.asarray(cell), n_cells, "count"))
    got = group_reduce.segment_reduce_cells_plain(None, cell_t, n_cells, "count")
    np.testing.assert_array_equal(got.numpy(), want)
    for name, v in vals.items():
        acc = np.float64 if v.dtype.kind == "f" else np.int64
        want = np.asarray(tpu_prims.segment_reduce_cells(
            jnp.asarray(v.astype(acc)), jnp.asarray(cell), n_cells, "sum"))
        got = group_reduce.segment_reduce_cells_plain(_view(v), cell_t, n_cells, "sum")
        assert got.dtype == (torch.float64 if acc is np.float64 else torch.int64), name
        _assert_same(got.numpy(), want)
        for kind in ("min", "max"):
            w = special.get(name, v)
            sentinel = group_reduce.extreme(torch.as_tensor(w).dtype, kind == "min")
            want = np.asarray(tpu_prims.segment_reduce_cells(
                jnp.asarray(w), jnp.asarray(cell), n_cells, kind,
                sentinel=jnp.asarray(sentinel, dtype=w.dtype)))
            got = group_reduce.segment_reduce_cells_plain(_view(w), cell_t, n_cells, kind,
                                                          sentinel)
            assert got.numpy().dtype == w.dtype
            _assert_same(got.numpy(), want)


# -- K6: fused_cells_reduce_plain through FusedFilterAggregate -----------------------

# the group-by columns' dictionary sizes that make each cell count
_KEY_SIZES = {1: [], 2: [2], 8: [8], 9: [3, 3], 63: [7, 9], 64: [8, 8]}


def _edge_tables(n: int, n_cells: int):
    """The same table in both packages: string keys whose dictionaries give
    n_cells cells (every value present), the four input types, nullable
    float64 and int32 inputs, a float64 column with NaN and +-inf."""
    rng = np.random.default_rng(n * 7 + n_cells)
    T = JaxDataType
    vals, special = _values(rng, n)
    defs, arrays, validities = [], [], []
    for g, size in enumerate(_KEY_SIZES[n_cells]):
        codes = rng.integers(0, size, n)
        codes[:size] = np.arange(size)  # every dictionary value present
        defs.append(JaxDef(f"k{g}", T.STRING))
        arrays.append(np.array([f"v{j:02d}" for j in range(size)], dtype=object)[codes])
        validities.append(None)
    for name, dt in (("float64", T.FLOAT64), ("float32", T.FLOAT32), ("int64", T.INT64),
                     ("int32", T.INT32)):
        defs.append(JaxDef(name, dt, name in ("float64", "int32")))
        arrays.append(vals[name])
        validities.append(rng.random(n) < 0.7 if name in ("float64", "int32") else None)
    defs += [JaxDef("special", T.FLOAT64), JaxDef("ship", T.INT32)]
    arrays += [special["float64"], rng.integers(0, 100, n).astype(np.int32)]
    validities += [None, None]
    jt = JaxTable.from_arrays("t", defs, arrays, validities)
    cols = [(c.name, c.dtype.value, np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity), c.dictionary)
            for c in jt.columns]
    return jt, table_from_numpy("t", cols, jt.num_rows, None, device="cpu")


def _edge_aggregates(A, fn_enum):
    c = A.col
    specs = [("n", "COUNT", None)]
    for name in ("float64", "float32", "int64", "int32"):
        specs += [(f"sum_{name}", "SUM", c(name)), (f"min_{name}", "MIN", c(name)),
                  (f"max_{name}", "MAX", c(name)), (f"count_{name}", "COUNT", c(name))]
    specs += [("min_special", "MIN", c("special")), ("max_special", "MAX", c("special"))]
    return [(name, A.AggregateExpr(getattr(fn_enum, fn), arg)) for name, fn, arg in specs]


def _same_value(got, want) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, str):
        return got == want
    if isinstance(want, (float, np.floating)):
        g, w = float(got), float(want)
        if math.isnan(w) or math.isinf(w):
            return math.isnan(g) if math.isnan(w) else g == w
        return math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return int(got) == int(want)


# the JAX form's fast path takes some 20 s a shape to compile at 63 and 64
# cells on the CPU: it runs there at one size, its plain form at all
FUSED_EDGES = [(n, c, fast) for n in (1023, 1024, 2048, 2049, 9 * 2048 + 7)
               for c in EDGE_CELLS for fast in ("0", "1") if c <= 9 or fast == "0" or n == 2049]


@pytest.mark.parametrize("n,n_cells,fast", FUSED_EDGES)
def test_fused_filter_aggregate_edges_match_jax(n, n_cells, fast, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", fast)
    jt, pt = _edge_tables(n, n_cells)
    groupby = [f"k{g}" for g in range(len(_KEY_SIZES[n_cells]))]
    op = FusedFilterAggregate(TableWrapper(pt), ast.col("ship") < ast.lit(80), groupby,
                              _edge_aggregates(ast, AggregateFunction))
    got = execute_plan(op)
    assert op.fell_back is False
    from hyrise_tpu.expression import ast as jax_ast
    want = jax_execute_plan(JaxFused(JaxTableWrapper(jt), jax_ast.col("ship") < jax_ast.lit(80),
                                     groupby, _edge_aggregates(jax_ast, JaxAgg)))
    assert got.column_names == want.column_names
    got_rows, want_rows = got.rows(), want.rows()
    assert len(got_rows) == len(want_rows) == n_cells
    for g, w in zip(got_rows, want_rows):
        assert all(_same_value(a, b) for a, b in zip(g, w)), (g, w)


@pytest.mark.parametrize("n", [0, 1023, 2049])
def test_fused_cells_reduce_plain_is_the_same_on_views(n):
    """The wrapper's plain version on columns one element into their
    buffers equals it on contiguous copies (the kernel's staging starts
    such columns inside a 16-byte chunk)."""
    rng = np.random.default_rng(n)
    vals, special = _values(rng, n)
    mask, valid = rng.random(n) < 0.8, rng.random(n) < 0.6
    key = rng.integers(0, 9, n).astype(np.int32)
    slots = [(v, valid if i % 2 else None, kind) for i, v in enumerate(vals.values())
             for kind in ("sum", "min", "max")]
    slots += [(special["float32"], None, "min"), (None, valid, "count")]

    def run(make):
        return fused_reduce.fused_cells_reduce(
            make(mask), [make(key)], [9],
            [(None if v is None else make(v), None if m is None else make(m), kind)
             for v, m, kind in slots])

    (c1, r1), (c2, r2) = run(_view), run(torch.as_tensor)
    assert torch.equal(c1, c2)
    for (a, na), (b, nb) in zip(r1, r2):
        assert torch.equal(na, nb)
        _assert_same(a.numpy(), b.numpy())


# -- host-side launch shapes ---------------------------------------------------------


@pytest.mark.parametrize("n,sms,tile,want", [
    (0, 132, 2048, 1), (1, 132, 2048, 1), (2048, 132, 2048, 1), (2049, 132, 2048, 2),
    (2049, 132, 1024, 3), (6_006_330, 132, 2048, 1056), (6_006_330, 2, 2048, 16),
])
def test_max_blocks(n, sms, tile, want):
    assert fused_reduce.max_blocks(n, sms, tile) == want


def test_shared_bytes():
    # the job, 2 stages x (2,048 x 4 + 16 + 2,048 x 8 + 16), 6 x 8 x 8, 2,048 + 16 + 16
    assert fused_reduce.shared_bytes([4, 8], 6, 8, 8) == 1280 + 2 * 24608 + 384 + 2080
    # 4 rows a thread: tiles of 1,024 rows; 64 cells x 2 accumulators, 32 folders
    assert fused_reduce.shared_bytes([1, 4], 128, 4, 32) == 1280 + 2 * 5152 + 32768 + 1056


@pytest.mark.parametrize("column_bytes,n_acc,n_cells,rows,want", [
    # Q1: 2,048-row tiles of 29 bytes a row do not leave room for two blocks;
    # 1,024-row tiles do
    ([1, 4, 4, 4, 4, 4, 4, 4], 6, 6, (8, 4), (4, 0, 64288)),
    # Q6
    ([1, 4], 2, 1, (8, 4), (8, 0, 24032)),
    # 9 cells: 128 folders
    ([1, 4], 2, 9, (8, 4), (8, 128, 42336)),
    # 64 cells, float64: 128 folders at 4 rows a thread come before 64 at 8
    ([4, 8], 1, 64, (8, 4), (4, 128, 92512)),
    # nothing leaves room for two blocks: the smallest shape
    ([8] * 12, 13, 64, (8, 4), (4, 32, 1280 + 2 * (12 * 8208) + 13 * 64 * 32 * 8 + 1056)),
])
def test_launch_shape(column_bytes, n_acc, n_cells, rows, want):
    assert fused_reduce.launch_shape(column_bytes, n_acc, n_cells, rows) == want
    rows_, folders, shared = want
    assert shared == fused_reduce.shared_bytes(column_bytes, n_acc * n_cells, rows_,
                                               folders or fused_reduce.WARPS)


def test_the_engine_header_is_hashed_with_k6(tmp_path):
    assert [p.name for p in build._source_files("fused_reduce", build.CSRC_DIR)] == \
        ["fused_reduce.cu", "cells_reduce.cuh"]
    # K3 uses the engine's fold helpers
    assert [p.name for p in build._source_files("group_reduce", build.CSRC_DIR)] == \
        ["group_reduce.cu", "cells_reduce.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    header = csrc / "cells_reduce.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, rebuilt in (("fused_reduce", True), ("group_reduce", True),
                          ("compact", False)):
        assert (build._library_path(name, csrc) != build._library_path(name)) is rebuilt


def test_cpu_tensors_launch_nothing():
    before = (group_reduce.segment_reduce_cells.launches,
              fused_reduce.fused_cells_reduce.launches)
    cell = torch.zeros(3000, dtype=torch.int32)
    group_reduce.segment_reduce_cells(None, cell, 9, "count")
    fused_reduce.fused_cells_reduce(torch.ones(3000, dtype=torch.bool), [cell], [9], [])
    assert before == (group_reduce.segment_reduce_cells.launches,
                      fused_reduce.fused_cells_reduce.launches)

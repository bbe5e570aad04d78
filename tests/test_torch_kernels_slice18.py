"""K3 as one pass over every reduction of an Aggregate: the plain version of
segment_reduce_cells_many against the JAX segment_reduce_cells slot by slot,
its launch planning, and the callers that make one call an Aggregate (the
dense tier of ops/aggregate.py, parallel/dist_query.py's dist_q1).

The JAX function runs in both of its formulations (HYRISE_TPU_FASTPATH 0
and 1), as tests/test_torch_prims.py runs it; a slot's validity moves its
invalid rows outside the cell space on the JAX side. Integers match
exactly, float64 within 1e-12 relative (another summation order), NaN where
JAX has NaN. The CUDA kernel itself is held against this plain version on
the card by chip_smoke.py (phase 3, `--cells`, `--kernels K3`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyrise_tpu.expression.ast as jax_ast
import hyrise_tpu.ops as jax_ops
import hyrise_tpu_torch.expression.ast as torch_ast
import hyrise_tpu_torch.ops as torch_ops
from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.storage.column import Column as JaxColumn
from hyrise_tpu.storage.table import Table as JaxTable
from hyrise_tpu.tpch.dbgen import generate_tables as jax_generate_tables
from hyrise_tpu_torch.kernels import group_reduce
from hyrise_tpu_torch.parallel import dist_query
from hyrise_tpu_torch.parallel.mesh import make_mesh
from hyrise_tpu_torch.parallel.partition import hash_partition
from hyrise_tpu_torch.storage.interop import table_from_numpy
from hyrise_tpu_torch.tpch.dbgen import generate_tables

torch.set_num_threads(1)

CELL_COUNTS = (1, 2, 6, 25, 63, 64)
ROW_COUNTS = (0, 1, 2047, 2049, 65_543)


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _inputs(n: int, n_cells: int):
    """Seeded values of the four types (NaN, +inf and -inf planted in the
    floats), cell ids with rows outside the cell space on both sides, and
    two validity columns."""
    rng = np.random.default_rng(n * 37 + n_cells)
    values = {
        "float64": rng.random(n) * 1e4 - 3e3,
        "float32": (rng.random(n) * 100 - 20).astype(np.float32),
        "int64": rng.integers(-10**12, 10**12, n),
        "int32": rng.integers(-10**6, 10**6, n).astype(np.int32),
    }
    for name in ("float64", "float32"):
        at = rng.permutation(n)[:3]
        values[name][at] = np.array([np.nan, np.inf, -np.inf], dtype=values[name].dtype)[:len(at)]
    cell = rng.integers(-1, n_cells + 2, n).astype(np.int32)
    valid = [rng.random(n) < 0.7, rng.random(n) < 0.95]
    return values, cell, valid


def _slots(values, valid):
    """Every (type, fold) with and without a validity column, and counts:
    (values name or None, validity number or None, kind)."""
    slots = [(None, None, "count"), (None, 0, "count"), (None, 1, "count")]
    for i, name in enumerate(sorted(values)):
        slots += [(name, None, "sum"), (name, i % 2, "sum"), (name, None, "min"),
                  (name, (i + 1) % 2, "min"), (name, 1, "max"), (name, None, "max")]
    return slots


def _jax_reduce(values, cell, n_cells, kind):
    if kind == "count":
        return np.asarray(tpu_prims.segment_reduce_cells(
            jnp.ones(cell.shape[0], dtype=jnp.int64), jnp.asarray(cell), n_cells, "count"))
    if kind == "sum":
        acc = np.float64 if values.dtype.kind == "f" else np.int64
        return np.asarray(tpu_prims.segment_reduce_cells(
            jnp.asarray(values.astype(acc)), jnp.asarray(cell), n_cells, "sum"))
    sentinel = group_reduce.extreme(torch.as_tensor(values).dtype, kind == "min")
    if cell.shape[0] == 0:  # the JAX fast path cannot take the min of no rows
        return np.full(n_cells, sentinel, dtype=values.dtype)
    return np.asarray(tpu_prims.segment_reduce_cells(
        jnp.asarray(values), jnp.asarray(cell), n_cells, kind,
        sentinel=jnp.asarray(sentinel, dtype=values.dtype)))


def _assert_same(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_cells", CELL_COUNTS)
@pytest.mark.parametrize("n", ROW_COUNTS)
def test_many_plain_matches_jax_slot_by_slot(n, n_cells, fastpath):
    values, cell, valid = _inputs(n, n_cells)
    slots = _slots(values, valid)
    t_values = {k: torch.as_tensor(v) for k, v in values.items()}
    t_valid = [torch.as_tensor(v) for v in valid]
    counts, got = group_reduce.segment_reduce_cells_many_plain(
        torch.as_tensor(cell), n_cells,
        [(None if name is None else t_values[name], None if v is None else t_valid[v], kind)
         for name, v, kind in slots])
    _assert_same(counts.numpy(), _jax_reduce(None, cell, n_cells, "count"))
    assert len(got) == len(slots)
    for (name, v, kind), (result, n_valid) in zip(slots, got):
        cell_s = cell if v is None else np.where(valid[v], cell, n_cells).astype(np.int32)
        _assert_same(n_valid.numpy(), _jax_reduce(None, cell_s, n_cells, "count"))
        want = _jax_reduce(None if name is None else values[name], cell_s, n_cells, kind)
        if kind in ("min", "max"):
            assert result.numpy().dtype == values[name].dtype
        _assert_same(result.numpy(), want)


@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32"])
def test_one_slot_call_equals_segment_reduce_cells(dtype, kind):
    values, cell, _ = _inputs(4099, 9)
    v, c = torch.as_tensor(values[dtype]), torch.as_tensor(cell)
    sentinel = group_reduce.extreme(v.dtype, kind == "min") if kind in ("min", "max") else None
    counts, ((result, n_valid),) = group_reduce.segment_reduce_cells_many_plain(
        c, 9, [(None if kind == "count" else v, None, kind)])
    want = group_reduce.segment_reduce_cells_plain(v, c, 9, kind, sentinel)
    assert torch.equal(counts, group_reduce.segment_reduce_cells_plain(None, c, 9, "count"))
    assert torch.equal(n_valid, counts)
    assert result.dtype == want.dtype
    assert torch.equal(result.nan_to_num(), want.nan_to_num())
    assert torch.equal(group_reduce.segment_reduce_cells(v, c, 9, kind, sentinel).nan_to_num(),
                       want.nan_to_num())


def test_cpu_tensors_launch_nothing():
    values, cell, valid = _inputs(2049, 6)
    before = group_reduce.segment_reduce_cells.launches
    group_reduce.segment_reduce_cells_many(
        torch.as_tensor(cell), 6,
        [(torch.as_tensor(values["float32"]), torch.as_tensor(valid[0]), "sum"),
         (None, torch.as_tensor(valid[1]), "count"),
         (torch.as_tensor(values["int64"]), None, "max")])
    group_reduce.segment_reduce_cells(None, torch.as_tensor(cell), 6, "count")
    assert group_reduce.segment_reduce_cells.launches == before


def test_many_rejects_what_the_kernel_does_not_take():
    v, c = torch.zeros(8, dtype=torch.float64), torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=torch.bool)
    many = group_reduce.segment_reduce_cells_many
    for bad, error in (((c, 65, [(v, None, "sum")]), ValueError),
                       ((c, 4, [(v, None, "median")]), ValueError),
                       ((c, 4, [(v.to(torch.float16), None, "sum")]), TypeError),
                       ((c, 4, [(None, None, "min")]), TypeError),
                       ((c, 4, [(v, m[:4], "sum")]), ValueError),
                       ((c, 4, [(v, m.to(torch.uint8), "sum")]), TypeError),
                       ((c, 4, [(v[::2], None, "sum")]), ValueError),
                       ((c.to("meta"), 4, [(v.to("meta"), None, "sum")]), ValueError)):
        with pytest.raises(error):
            many(*bad)


# -- the launch plan (pure Python) --------------------------------------------------


def test_shared_bytes_and_blocks():
    # a flag, 8 bytes an accumulator a thread up to 8 cells (a warp above), a
    # byte a thread a validity column
    assert group_reduce.shared_bytes(6, 0, 4) == 16 + 256 * 8 * 5 * 6
    assert group_reduce.shared_bytes(64, 3, 5) == 16 + 8 * 8 * 9 * 64 + 3 * 256
    assert [group_reduce.tile_rows(k) for k in (1, 8, 9, 64)] == [2048, 2048, 1024, 1024]
    assert [group_reduce.launch_blocks(n, 6, 132) for n in (0, 1, 2048, 2049, 6_006_330)] == \
        [1, 1, 1, 2, 396]
    assert [group_reduce.launch_blocks(n, 25, 132) for n in (1024, 1025, 6_006_330)] == \
        [1, 2, 396]


@pytest.mark.parametrize("n_cells, items, launches", [
    # Q1's dense Aggregate: four sums, one launch
    (6, [(True, -1)] * 4, [[0, 1, 2, 3]]),
    # 17 folds: the kernel takes 16 a launch
    (1, [(True, -1)] * 17, [list(range(16)), [16]]),
    # 17 validity columns counted alone: 16 a launch
    (2, [(False, v) for v in range(17)], [list(range(16)), [16]]),
    # 64 cells (a row of accumulators a warp), a validity column a fold: 1 +
    # 13 + 13 accumulators leave room for two blocks an SM (114,000 bytes of
    # shared memory), 1 + 14 + 14 do not (122,208), so 13 folds a launch
    (64, [(True, v) for v in range(16)], [list(range(13)), [13, 14, 15]]),
    # 8 cells (a row a thread): 1 + 6 accumulators fit (114,704), 1 + 7 do not
    (8, [(True, -1)] * 16, [list(range(6)), list(range(6, 12)), [12, 13, 14, 15]]),
])
def test_plan_launches_splits(n_cells, items, launches):
    plan = group_reduce.plan_launches(n_cells, items)
    assert plan == launches
    for members in plan:
        validities = {items[m][1] for m in members if items[m][1] >= 0}
        folds = sum(items[m][0] for m in members)
        assert folds <= group_reduce.MAX_FOLDS
        assert len(validities) <= group_reduce.MAX_VALIDITIES
        assert group_reduce.shared_bytes(n_cells, len(validities), folds) <= 228 * 1024 // 2 - 1024


# -- the callers: one K3 call an Aggregate ------------------------------------------


_tables = {}


def _lineitem_with_nulls():
    """TPC-H SF 0.01 lineitem as the JAX package generates it, with NULLs
    planted in three columns (two validity patterns), and the port's copy."""
    if not _tables:
        jt = jax_generate_tables(0.01)["lineitem"]
        rng = np.random.default_rng(18)
        masks = [rng.random(jt.capacity) < 0.8, rng.random(jt.capacity) < 0.6]
        nulls = {"l_quantity": 0, "l_discount": 0, "l_extendedprice": 1}
        cols = [c if c.name not in nulls else
                JaxColumn(c.name, c.dtype, c.data, jnp.asarray(masks[nulls[c.name]]),
                          c.dictionary)
                for c in jt.columns]
        jt = JaxTable(cols, jt.num_rows, name="lineitem")
        pt = table_from_numpy(
            "lineitem", [(c.name, c.dtype.value, np.asarray(c.data),
                          None if c.validity is None else np.asarray(c.validity),
                          c.dictionary) for c in jt.columns], jt.num_rows, device="cpu")
        _tables.update(jax=jt, port=pt)
    return _tables["jax"], _tables["port"]


def _aggregates(A):
    return [("sum_qty", A.sum_(A.col("l_quantity"))),
            ("avg_price", A.avg_(A.col("l_extendedprice"))),
            ("sum_price", A.sum_(A.col("l_extendedprice"))),
            ("min_disc", A.min_(A.col("l_discount"))),
            ("max_tax", A.max_(A.col("l_tax"))),
            ("cnt_price", A.count_(A.col("l_extendedprice"))),
            ("cnt", A.count_()),
            ("sum_disc_price", A.sum_(A.col("l_extendedprice") * A.col("l_discount"))),
            ("max_ship", A.max_(A.col("l_shipdate"))),
            ("min_qty", A.min_(A.col("l_quantity"))),
            ("sum_line", A.sum_(A.col("l_linenumber")))]


@pytest.mark.parametrize("groupby", [["l_returnflag", "l_linestatus"], ["l_shipmode"], []],
                         ids=["6_cells", "7_cells", "global"])
def test_dense_aggregate_one_call_matches_jax_sf001(groupby, monkeypatch):
    import hyrise_tpu_torch.ops.aggregate as port_aggregate
    jt, pt = _lineitem_with_nulls()
    calls = []
    real = port_aggregate.segment_reduce_cells_many
    monkeypatch.setattr(port_aggregate, "segment_reduce_cells_many",
                        lambda cell, n, slots: calls.append(len(slots)) or real(cell, n, slots))
    got = torch_ops.execute_plan(torch_ops.Aggregate(torch_ops.TableWrapper(pt), groupby,
                                                     _aggregates(torch_ast))).rows()
    want = jax_ops.execute_plan(jax_ops.Aggregate(jax_ops.TableWrapper(jt), groupby,
                                                  _aggregates(jax_ast))).rows()
    assert calls == [10]  # every aggregate but COUNT(*), in one call
    assert len(got) == len(want) and len(got) >= 1
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b


def test_dist_q1_one_call_a_shard():
    li = generate_tables(0.01, device="cpu")["lineitem"]
    mesh = make_mesh(4, device="cpu")
    calls = []
    real = dist_query.segment_reduce_cells_many

    def counted(cell, n_cells, slots):
        calls.append(len(slots))
        return real(cell, n_cells, slots)
    hi = int(np.searchsorted(li.column("l_shipdate").dictionary, "1998-09-02", side="right")) - 1
    sharded = hash_partition(li, "l_orderkey", mesh)
    want = dist_query.dist_q1(mesh, sharded, hi)
    dist_query.segment_reduce_cells_many = counted
    try:
        got = dist_query.dist_q1(mesh, sharded, hi)
    finally:
        dist_query.segment_reduce_cells_many = real
    assert calls == [5] * 4  # the count and five sums, one call a shard
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0].sum()) > 0

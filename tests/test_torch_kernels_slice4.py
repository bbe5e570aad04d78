"""The shapes that the tiled K7 kernel (segment_reduce_sorted: blocks own
tiles of 2,048 positions of the group order) and the one-pass K9 kernel
(compact_indices: tiles of 8,192 mask rows) have to get right, through the
wrappers on CPU tensors (their plain versions) against the JAX package on the
same numpy inputs, run on the CPU in both formulations of tpu_prims
(HYRISE_TPU_FASTPATH). Integers, positions and counts must match exactly;
float64 sums within rtol 1e-12, atol 1e-9 (another summation order). The
CUDA kernels themselves are held against these plain versions, in the same
shapes, on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu_torch.kernels import prims

torch.set_num_threads(1)

TILE = 2048         # positions of the group order per block of the K7 kernel
MASK_TILE = 8192    # mask rows per block of the K9 kernel
N = 3 * TILE + 57


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# Binary fractions small enough that every partial sum is exact in float64:
# the cumsum formulation of the JAX package then loses nothing either.
VALUE_MAKERS = {
    "float64": lambda rng, n: rng.integers(-10**6, 10**7, n) / 128.0,
    "float32": lambda rng, n: (rng.integers(0, 2**14, n) / 4.0).astype(np.float32),
    "int64": lambda rng, n: rng.integers(-10**12, 10**12, n),
    "int32": lambda rng, n: rng.integers(-10**6, 10**6, n).astype(np.int32),
}


def _cut(rng, lo, hi, n_groups):
    cuts = np.sort(rng.integers(lo, hi + 1, max(n_groups - 1, 0)))
    return np.concatenate([[lo], cuts, [hi]])


def _one_group(rng):
    return np.array([0, N])


def _skewed(rng):
    """N // 4 groups of which one holds a third of the rows."""
    big = N // 3
    rest = _cut(rng, 0, N - big, N // 4 - 1)
    at = len(rest) // 2
    return np.concatenate([rest[:at + 1], rest[at:] + big])


def _tile_boundaries(rng):
    """Every boundary on a multiple of the tile; the rows after the last
    whole tile belong to no group."""
    return np.arange(0, N + 1, TILE)


def _empty_runs(rng):
    """Runs of empty groups at the first position, on a tile boundary and at
    the last position, among groups of about 4 rows."""
    return np.sort(np.concatenate([_cut(rng, 0, N, N // 4),
                                   np.repeat([0, 2 * TILE, N], 40)]))


def _offset_start(rng):
    """starts[0] > 0, past the first tile; the last rows belong to no group."""
    return _cut(rng, TILE + 3, N - 100, 300)


SEGMENT_SHAPES = {"one_group": _one_group, "skewed": _skewed,
                  "tile_boundaries": _tile_boundaries, "empty_runs": _empty_runs,
                  "offset_start": _offset_start}


def _inputs(shape, dtype):
    rng = np.random.default_rng(sorted(SEGMENT_SHAPES).index(shape) * 101 + 4)
    starts = SEGMENT_SHAPES[shape](rng).astype(np.int64)
    return (VALUE_MAKERS[dtype](rng, N), starts, rng.permutation(N).astype(np.int64),
            rng.random(N) < 0.7)


def _oracle(values, starts, kind, rows, validity):
    """Per group, by numpy over the group's valid rows."""
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
        elif len(idx) == 0:
            lim = np.finfo(values.dtype) if values.dtype.kind == "f" \
                else np.iinfo(values.dtype)
            if values.dtype.kind == "f":
                out.append(np.inf if kind == "min" else -np.inf)
            else:
                out.append(lim.max if kind == "min" else lim.min)
        else:
            out.append(values[idx].min() if kind == "min" else values[idx].max())
    return np.array(out), np.array(counts, dtype=np.int64)


def test_the_shapes_are_what_they_claim():
    rng = np.random.default_rng(0)
    for name, make in SEGMENT_SHAPES.items():
        starts = make(rng)
        assert (np.diff(starts) >= 0).all() and starts[0] >= 0 and starts[-1] <= N, name
    sizes = np.diff(_skewed(rng))
    assert len(sizes) == N // 4 and sizes.max() >= N // 3
    assert (_tile_boundaries(rng) % TILE == 0).all()
    runs = _empty_runs(rng)
    assert (runs == 2 * TILE).sum() >= 40 and (runs == 0).sum() >= 40
    assert _offset_start(rng)[0] > TILE


@pytest.mark.parametrize("with_rows,with_validity", [(False, False), (True, False),
                                                     (True, True), (False, True)])
@pytest.mark.parametrize("shape", sorted(SEGMENT_SHAPES))
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_sorted_shapes_sum_matches_jax(dtype, shape, with_rows,
                                                      with_validity, fastpath):
    values, starts, rows, validity = _inputs(shape, dtype)
    rows = rows if with_rows else None
    validity = validity if with_validity else None
    n_groups = len(starts) - 1
    before = (prims.segment_reduce_sorted.launches, prims.segment_reduce_sorted.rows_seen)
    got, n_valid = prims.segment_reduce_sorted(
        _t(values), _t(starts), "sum", None if rows is None else _t(rows),
        None if validity is None else _t(validity))
    # CPU: no kernel
    assert before == (prims.segment_reduce_sorted.launches,
                      prims.segment_reduce_sorted.rows_seen)
    is_float = values.dtype.kind == "f"
    assert got.dtype == (torch.float64 if is_float else torch.int64)
    assert got.shape == n_valid.shape == (n_groups,)
    _, want_counts = _oracle(values, starts, "count", rows, validity)
    np.testing.assert_array_equal(n_valid.numpy(), want_counts)
    # the JAX form takes the values already gathered into group order, NULL
    # inputs as zeros, and a group id per row (out of range outside the groups)
    d = values if rows is None else values[rows]
    v = np.ones(N, dtype=bool) if validity is None else \
        (validity if rows is None else validity[rows])
    acc = np.float64 if is_float else np.int64
    gid = np.full(N, n_groups, dtype=np.int64)
    gid[starts[0]:starts[-1]] = np.repeat(np.arange(n_groups), np.diff(starts))
    jax_sums = np.asarray(tpu_prims.segment_sums_sorted(
        jnp.asarray(np.where(v, d, 0).astype(acc)), jnp.asarray(starts[:-1]),
        jnp.asarray(np.diff(starts)), N, gid=jnp.asarray(gid)))
    if is_float:
        np.testing.assert_allclose(got.numpy(), jax_sums, rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got.numpy(), jax_sums)


@pytest.mark.parametrize("kind", ["min", "max", "count"])
@pytest.mark.parametrize("shape", sorted(SEGMENT_SHAPES))
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_sorted_shapes_extrema_and_counts(dtype, shape, kind):
    values, starts, rows, validity = _inputs(shape, dtype)
    got, n_valid = prims.segment_reduce_sorted(
        None if kind == "count" else _t(values), _t(starts), kind, _t(rows),
        _t(validity))
    want, want_counts = _oracle(values, starts, kind, rows, validity)
    np.testing.assert_array_equal(n_valid.numpy(), want_counts)
    if kind != "count":
        assert got.dtype == _t(values).dtype  # exact in the input's type
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


@pytest.mark.parametrize("shape", sorted(SEGMENT_SHAPES))
def test_segment_count_without_validity_is_the_group_size(shape):
    _, starts, rows, _ = _inputs(shape, "int32")
    for r in (None, _t(rows)):
        got, n_valid = prims.segment_reduce_sorted(None, _t(starts), "count", r)
        np.testing.assert_array_equal(got.numpy(), np.diff(starts))
        np.testing.assert_array_equal(n_valid.numpy(), np.diff(starts))


# -- K9 compact_indices --------------------------------------------------------------


@pytest.mark.parametrize("share", [0.02, 0.5, 0.98])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, MASK_TILE - 1, MASK_TILE,
                               MASK_TILE + 1, 65_543])
def test_compact_indices_tile_edges_match_jax(n, share, fastpath):
    mask = np.random.default_rng(n * 3 + int(share * 100)).random(n) < share
    before = (prims.compact_indices.launches, prims.compact_indices.rows_seen)
    got = prims.compact_indices(_t(mask))
    # CPU: no kernel
    assert before == (prims.compact_indices.launches, prims.compact_indices.rows_seen)
    assert got.dtype == torch.int64
    count = int(mask.sum())
    cap = max(n, 1)
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(mask))
    want = np.asarray(tpu_prims.compact_indices(jnp.asarray(mask), cap))[:count]
    np.testing.assert_array_equal(got.numpy(), want)
    if n:
        scattered = np.asarray(tpu_prims.positions_of_true(jnp.asarray(mask), cap))[:count]
        np.testing.assert_array_equal(got.numpy(), scattered)


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("n", [2047, MASK_TILE + 1, 65_543])
def test_compact_indices_of_a_view_off_an_8_byte_boundary(n, offset, fastpath):
    whole = _t(np.random.default_rng(n + offset).random(n + offset) < 0.5)
    view = whole[offset:]
    assert view.is_contiguous() and view.data_ptr() % 8 != whole.data_ptr() % 8
    got = prims.compact_indices(view)
    count = int(view.sum())
    want = np.asarray(tpu_prims.compact_indices(jnp.asarray(view.numpy()), n))[:count]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(view.numpy()))


def test_the_wrappers_count_launches_and_rows():
    for wrapper in (prims.compact_indices, prims.segment_reduce_sorted):
        assert isinstance(wrapper.launches, int) and isinstance(wrapper.rows_seen, int)

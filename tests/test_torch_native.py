"""The port's native library (hyrise_tpu_torch/native.py) against its plain
numpy versions and against the JAX package's bindings.

The library is built with g++ from the shared native/hyrise_native.cpp at
first use into hyrise_tpu_torch/kernels/_build/; the JAX package's
hyrise_tpu/native.py is its ctypes twin over native/libhyrise_native.so
(or its numpy fallback where that is absent), so both must give the same
shard targets and row orders."""

import numpy as np
import pytest

from hyrise_tpu import native as jax_native
from hyrise_tpu_torch import native

INT64 = np.iinfo(np.int64)
KEYS = np.concatenate([
    np.array([0, 1, -1, 2, INT64.min, INT64.max, INT64.min + 1, INT64.max - 1], dtype=np.int64),
    np.random.default_rng(0).integers(INT64.min, INT64.max, 10_000, dtype=np.int64),
    np.arange(-500, 500, dtype=np.int64)])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 8, 64])
def test_hash_partition_equals_plain_and_jax(n_shards):
    got = native.hash_partition(KEYS, n_shards)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, native.hash_partition_plain(KEYS, n_shards))
    np.testing.assert_array_equal(got, jax_native.hash_partition(KEYS, n_shards))
    assert got.min() >= 0 and got.max() < n_shards


def test_hash_partition_takes_other_int_types():
    keys = np.arange(-100, 100, dtype=np.int32)
    np.testing.assert_array_equal(native.hash_partition(keys, 8),
                                  native.hash_partition_plain(keys.astype(np.int64), 8))
    assert native.hash_partition(np.empty(0, dtype=np.int64), 4).shape == (0,)
    with pytest.raises(ValueError):
        native.hash_partition(keys, 0)


@pytest.mark.parametrize("n_rows", [0, 1, 17, 5000])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_radix_route_equals_plain_and_jax(n_rows, n_shards):
    targets = np.random.default_rng(n_rows).integers(0, n_shards, n_rows).astype(np.int32)
    hist, order = native.radix_route(targets, n_shards)
    p_hist, p_order = native.radix_route_plain(targets, n_shards)
    j_hist, j_order = jax_native.radix_route(targets, n_shards)
    for a, b in ((hist, p_hist), (hist, j_hist), (order, p_order), (order, j_order)):
        np.testing.assert_array_equal(a, b)
    assert hist.dtype == np.int64 and order.dtype == np.int64
    # stable: each shard's rows in table order
    offsets = np.concatenate([[0], np.cumsum(hist)])
    for s in range(n_shards):
        rows = order[offsets[s]:offsets[s + 1]]
        assert (targets[rows] == s).all() and (np.diff(rows) > 0).all()


def test_radix_route_refuses_targets_outside_the_shards():
    with pytest.raises(ValueError):
        native.radix_route(np.array([0, 4], dtype=np.int32), 4)
    with pytest.raises(ValueError):
        native.radix_route_plain(np.array([-1], dtype=np.int32), 4)


TEXT = ("a|1|2.5|x\n"
        "b|-7|1e3|y\n"
        "\n"
        "c|42|-0.125|z\n"
        "d|notanumber|nan|w\n"
        "e|9\n"
        "f|12abc|3.5xyz|v\n")


@pytest.mark.parametrize("col_idx,kind,skip", [(1, "l", 0), (2, "d", 0), (1, "l", 2),
                                                (2, "d", 1), (0, "l", 0), (3, "l", 0)])
def test_parse_text_column_equals_plain(tmp_path, col_idx, kind, skip):
    path = tmp_path / "t.tbl"
    path.write_text(TEXT)
    got = native.parse_text_column(str(path), "|", col_idx, kind, skip, 100)
    want = native.parse_text_column_plain(str(path), "|", col_idx, kind, skip, 100)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    jax_got = jax_native.parse_text_column(str(path), "|", col_idx, kind, skip, 100)
    if jax_got is not None:  # the JAX package's library is there
        np.testing.assert_array_equal(got, jax_got)


def test_parse_text_column_raises_where_the_jax_binding_returns_none(tmp_path):
    path = tmp_path / "t.tbl"
    path.write_text(TEXT)
    with pytest.raises(ValueError):
        native.parse_text_column(str(path), "|", 1, "l", 0, 2)
    with pytest.raises(OSError):
        native.parse_text_column(str(tmp_path / "missing.tbl"), "|", 1, "l", 0, 2)


def test_library_is_built_under_a_hashed_name():
    path = native.library_path()
    assert path.parent.name == "_build" and path.name.startswith("libhyrise_native-")
    native.hash_partition(KEYS[:3], 2)
    assert path.exists()

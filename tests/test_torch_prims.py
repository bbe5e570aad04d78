"""The port's shared primitives (hyrise_tpu_torch.kernels.prims, with the
plain versions of the K3, K4 and K5 kernels) against
hyrise_tpu.kernels.tpu_prims and hyrise_tpu.ops.join on the same numpy
inputs. The JAX forms run in both of their formulations
(HYRISE_TPU_FASTPATH 0 and 1, as tests/test_tpu_prims_fastpath.py runs
them on the CPU). Integers, row ids and flags must match exactly, float64
sums within 1e-12 relative (another summation order). The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.ops import join as jax_join
from hyrise_tpu_torch.kernels import group_reduce, join_probe, prims

torch.set_num_threads(1)


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- K3 segment_reduce_cells -------------------------------------------------------

VALUE_MAKERS = {
    "float64": lambda rng, n: rng.random(n) * 1e4 - 3e3,
    "float32": lambda rng, n: (rng.random(n) * 100).astype(np.float32),
    "int64": lambda rng, n: rng.integers(-10**12, 10**12, n),
    "int32": lambda rng, n: rng.integers(-10**6, 10**6, n).astype(np.int32),
}


def _cells(rng, n, n_cells):
    # some rows outside the cell space on both sides
    return rng.integers(-1, n_cells + 2, n).astype(np.int32)


@pytest.mark.parametrize("n_cells", [1, 4, 64])
@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_cells_sum_matches_jax(dtype, n, n_cells, fastpath):
    rng = np.random.default_rng(n * 131 + n_cells)
    values, cell = VALUE_MAKERS[dtype](rng, n), _cells(rng, n, n_cells)
    acc = np.float64 if values.dtype.kind == "f" else np.int64
    want = np.asarray(tpu_prims.segment_reduce_cells(
        jnp.asarray(values.astype(acc)), jnp.asarray(cell), n_cells, "sum"))
    before = prims.segment_reduce_cells.launches
    got = prims.segment_reduce_cells(_t(values), _t(cell), n_cells, "sum")
    assert prims.segment_reduce_cells.launches == before  # CPU: no kernel
    assert got.dtype == (torch.float64 if acc is np.float64 else torch.int64)
    if acc is np.int64:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n_cells", [1, 4, 64])
@pytest.mark.parametrize("n", [0, 1, 4099])
def test_segment_reduce_cells_count_matches_jax(n, n_cells, fastpath):
    rng = np.random.default_rng(n + n_cells)
    cell = _cells(rng, n, n_cells)
    want = np.asarray(tpu_prims.segment_reduce_cells(
        jnp.ones(n, dtype=jnp.int64), jnp.asarray(cell), n_cells, "count"))
    got = prims.segment_reduce_cells(None, _t(cell), n_cells, "count")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("n_cells", [1, 4, 64])
@pytest.mark.parametrize("dtype", sorted(VALUE_MAKERS))
def test_segment_reduce_cells_min_max_matches_jax(dtype, n_cells, kind, fastpath):
    n = 777
    rng = np.random.default_rng(n_cells)
    values, cell = VALUE_MAKERS[dtype](rng, n), _cells(rng, n, n_cells)
    cell[cell == n_cells - 1] = -1   # leave the last cell empty: it takes the sentinel
    if values.dtype.kind == "f":
        sentinel = np.inf if kind == "min" else -np.inf
    else:
        info = np.iinfo(values.dtype)
        sentinel = info.max if kind == "min" else info.min
    want = np.asarray(tpu_prims.segment_reduce_cells(
        jnp.asarray(values), jnp.asarray(cell), n_cells, kind,
        sentinel=jnp.asarray(sentinel, dtype=values.dtype)))
    got = prims.segment_reduce_cells(_t(values), _t(cell), n_cells, kind,
                                     sentinel=sentinel)
    assert got.numpy().dtype == values.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[n_cells - 1] == sentinel


def test_segment_reduce_cells_rejects_what_the_kernel_does_not_take():
    values, cell = torch.zeros(8, dtype=torch.float64), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values, cell, 65, "sum")
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values, cell, 0, "sum")
    with pytest.raises(TypeError):
        prims.segment_reduce_cells(values, cell.to(torch.int64), 4, "sum")
    with pytest.raises(TypeError):
        prims.segment_reduce_cells(values.to(torch.float16), cell, 4, "sum")
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values[:4], cell, 4, "sum")
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values, cell, 4, "min")  # no sentinel
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values, cell, 4, "median")
    with pytest.raises(ValueError):
        prims.segment_reduce_cells(values.to("meta"), cell.to("meta"), 4, "sum")
    assert group_reduce.DENSE_CELL_MAX == tpu_prims.DENSE_CELL_MAX


# -- K4 lookup_last_eq_lut, lookup_last_eq ------------------------------------------


def _lookup_case(seed, nb, nq, lo, hi):
    rng = np.random.default_rng(seed)
    # duplicate build keys, keys outside [lo, hi] on both sides, invalid rows
    bk = rng.integers(lo - 3, hi + 4, nb).astype(np.int64)
    bvalid = rng.random(nb) > 0.2
    pk = rng.integers(lo - 5, hi + 6, nq).astype(np.int64)
    return bk, bvalid, pk


def _lookup_oracle(bk, bvalid, pk, lo=None, hi=None):
    matched, row = np.zeros(len(pk), bool), np.zeros(len(pk), np.int64)
    for i, q in enumerate(pk):
        hits = np.nonzero((bk == q) & bvalid)[0]
        if lo is not None:
            hits = hits if lo <= q <= hi else hits[:0]
        if len(hits):
            matched[i], row[i] = True, hits.max()
    return matched, row


@pytest.mark.parametrize("nb,nq,lo,hi", [(50, 300, 0, 40), (1, 1, 7, 7),
                                         (0, 20, 0, 9), (200, 0, -50, 50),
                                         (500, 500, -1000, 3000)])
def test_lookup_last_eq_lut_matches_jax(nb, nq, lo, hi, fastpath):
    bk, bvalid, pk = _lookup_case(nb + nq, nb, nq, lo, hi)
    jm, jr = tpu_prims.lookup_last_eq_lut(jnp.asarray(bk), jnp.asarray(bvalid),
                                          jnp.asarray(pk), lo, hi)
    before = prims.lookup_last_eq_lut.launches
    matched, row = prims.lookup_last_eq_lut(_t(bk), _t(bvalid), _t(pk), lo, hi)
    assert prims.lookup_last_eq_lut.launches == before
    assert matched.dtype == torch.bool and row.dtype == torch.int64
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    om, orow = _lookup_oracle(bk, bvalid, pk, lo, hi)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)  # the LAST matching row


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("nb,nq", [(50, 300), (1, 1), (0, 20), (200, 0)])
def test_lookup_last_eq_matches_jax(nb, nq, dtype, fastpath):
    bk, bvalid, pk = _lookup_case(nb * 7 + nq, nb, nq, -20, 20)
    bk, pk = bk.astype(dtype), pk.astype(dtype)
    if nb:
        bk[0] = np.iinfo(np.int64).max if dtype is np.int64 else np.inf  # the JAX sentinel value
        bvalid[0] = True
    matched, row = prims.lookup_last_eq(_t(bk), _t(bvalid), _t(pk))
    assert row.dtype == torch.int64
    if nb:  # the JAX form cannot take from an empty build side
        jm, jr = tpu_prims.lookup_last_eq(jnp.asarray(bk), jnp.asarray(bvalid),
                                          jnp.asarray(pk))
        np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    om, orow = _lookup_oracle(bk, bvalid, pk)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(row.numpy(), orow)


def test_lookup_last_eq_lut_rejects_what_the_kernel_does_not_take():
    bk, bv, pk = _lookup_case(1, 10, 10, 0, 9)
    args = (_t(bk), _t(bv), _t(pk))
    with pytest.raises(ValueError):
        prims.lookup_last_eq_lut(*args, 0, join_probe.LUT_MAX_ENTRIES)  # one too many
    with pytest.raises(ValueError):
        prims.lookup_last_eq_lut(*args, 5, 4)
    with pytest.raises(TypeError):
        prims.lookup_last_eq_lut(args[0].to(torch.int32), *args[1:], 0, 9)
    with pytest.raises(TypeError):
        prims.lookup_last_eq_lut(args[0], args[1].to(torch.uint8), args[2], 0, 9)
    with pytest.raises(ValueError):
        prims.lookup_last_eq_lut(args[0], args[1][:5], args[2], 0, 9)
    with pytest.raises(ValueError):
        prims.lookup_last_eq_lut(*[a.to("meta") for a in args], 0, 9)
    assert join_probe.LUT_MAX_ENTRIES == tpu_prims.LUT_MAX_ENTRIES


# -- ranks ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("nb,nq", [(100, 400), (1, 3), (0, 5), (64, 0)])
def test_ranks_match_jax(nb, nq, dtype, fastpath):
    rng = np.random.default_rng(nb + nq)
    sk = np.sort(rng.integers(-10, 10, nb)).astype(dtype)
    q = rng.integers(-12, 12, nq).astype(dtype)
    jlo, jhi = tpu_prims.ranks_lo_hi(jnp.asarray(sk), jnp.asarray(q))
    lo, hi = prims.ranks_lo_hi(_t(sk), _t(q))
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    for side in ("left", "right"):
        want = tpu_prims.rank_in_sorted(jnp.asarray(sk), jnp.asarray(q), side)
        np.testing.assert_array_equal(
            prims.rank_in_sorted(_t(sk), _t(q), side).numpy(), np.asarray(want))


def test_sort_valid_keys_matches_jax_build_side():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 12, 200).astype(np.int64)
    keys[3] = np.iinfo(np.int64).max  # a real key equal to the JAX sentinel
    valid = rng.random(200) > 0.3
    valid[3] = True
    sk, perm, n_valid = jax_join._build_side(jnp.asarray(keys), jnp.asarray(valid))
    n_valid = int(n_valid)
    got_keys, got_perm = prims.sort_valid_keys(_t(keys), _t(valid))
    assert got_perm.dtype == torch.int64 and got_perm.shape[0] == n_valid
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(sk)[:n_valid])
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(perm)[:n_valid])


# -- K5 expand_pairs ------------------------------------------------------------------


@pytest.mark.parametrize("n_probe,n_build,max_count", [
    (1, 1, 1), (300, 80, 5), (50, 500, 400), (200, 40, 0), (0, 10, 3)])
def test_expand_pairs_matches_jax(n_probe, n_build, max_count, fastpath):
    rng = np.random.default_rng(n_probe + n_build)
    counts = rng.integers(0, max_count + 1, n_probe).astype(np.int32)
    counts = np.minimum(counts, n_build).astype(np.int32)
    counts[rng.random(n_probe) < 0.3] = 0          # rows that own no output
    lo = np.array([rng.integers(0, n_build - c + 1) for c in counts], dtype=np.int32)
    perm = rng.permutation(n_build).astype(np.int64)
    total = int(counts.sum())
    before = prims.expand_pairs.launches
    probe, rows = prims.expand_pairs(_t(lo), _t(counts), _t(perm))
    assert prims.expand_pairs.launches == before
    assert probe.dtype == torch.int64 and rows.dtype == torch.int64
    assert probe.shape[0] == rows.shape[0] == total
    want_probe = np.repeat(np.arange(n_probe), counts)
    want_rows = np.concatenate([perm[l:l + c] for l, c in zip(lo, counts)] or
                               [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(probe.numpy(), want_probe)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    if n_probe:  # the JAX form pads its output to out_cap
        jp, jb = jax_join._expand_pairs(jnp.asarray(lo), jnp.asarray(counts),
                                        jnp.asarray(perm.astype(np.int32)),
                                        out_cap=max(total, 1))
        np.testing.assert_array_equal(np.asarray(jp)[:total], want_probe)
        np.testing.assert_array_equal(np.asarray(jb)[:total], want_rows)


def test_expand_pairs_rejects_what_the_kernel_does_not_take():
    lo, counts = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    perm = torch.arange(4)
    with pytest.raises(TypeError):
        prims.expand_pairs(lo.to(torch.int64), counts, perm)
    with pytest.raises(TypeError):
        prims.expand_pairs(lo, counts, perm.to(torch.int32))
    with pytest.raises(ValueError):
        prims.expand_pairs(lo[:2], counts, perm)
    with pytest.raises(ValueError):
        prims.expand_pairs(lo.to("meta"), counts.to("meta"), perm.to("meta"))


@pytest.mark.parametrize("lo,counts", [([0, 3], [1, 2]), ([-1, 0], [1, 1]),
                                       ([0, 0], [1, -1]), ([5, 0], [0, 1]),
                                       ([2**31 - 1, 0], [2**31 - 1, 1])],
                         ids=["end_past_build", "negative_lo", "negative_count",
                              "empty_range_past_build", "end_past_int32"])
def test_expand_pairs_rejects_ranges_outside_the_build_side(lo, counts):
    perm = torch.arange(4)
    with pytest.raises(ValueError, match="outside the build side"):
        prims.expand_pairs(torch.tensor(lo, dtype=torch.int32),
                           torch.tensor(counts, dtype=torch.int32), perm)

"""The shapes that the K5 kernels (expand_pairs: a scan over tiles of 16,384
ranges with segments of 512, then blocks that own 2,048 output positions) and
the K4 kernels (lookup_last_eq_lut: four probe rows a thread, two build rows a
thread) have to get right, through the wrappers on CPU tensors (their plain
versions) against the JAX package on the same numpy inputs, run on the CPU in
both formulations of tpu_prims (HYRISE_TPU_FASTPATH), and against numpy
oracles. Everything here is integers, row ids and flags: exact equality. The
CUDA kernels themselves are held against these plain versions, in the same
shapes, on the card by chip_smoke.py. Also: the build's hash of a source
covers the headers it includes."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.ops import join as jax_join
from hyrise_tpu_torch.kernels import build, join_probe, prims

torch.set_num_threads(1)

SCAN_TILE = 16384   # ranges per block of K5's scan kernel
SEGMENT = 512       # ranges per end offset that the scan hands to the expansion
OUT_TILE = 2048     # output pairs per block of K5's expansion kernel
PROBE_ROWS = 4      # probe rows a thread of K4's probe kernel takes at a time
N_BUILD = 3000


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- K5 expand_pairs -----------------------------------------------------------------


def _random_ranges(rng, n_probe, max_count=3):
    counts = rng.integers(0, max_count + 1, n_probe)
    return rng.integers(0, N_BUILD, n_probe) % (N_BUILD - counts + 1), counts


def _few(rng):
    """Every count 0 but five, spread over several scan tiles."""
    counts = np.zeros(3 * SCAN_TILE + 57, dtype=np.int64)
    counts[rng.choice(len(counts), 5, replace=False)] = rng.integers(1, 4, 5)
    return np.minimum(counts, 1) * 7, counts


def _whole_build_side(rng):
    return np.array([0]), np.array([N_BUILD])


def _triangular(rng):
    """The ranges of a `<` join over sorted keys: row p matches p build rows."""
    return np.zeros(700, dtype=np.int64), np.arange(700)


def _one_long_range(rng):
    """One range across many output tiles, among empty ones."""
    counts = np.zeros(1000, dtype=np.int64)
    counts[500] = N_BUILD
    return np.zeros(1000, dtype=np.int64), counts


def _skewed(rng):
    """A third of the pairs from one probe row."""
    lo, counts = _random_ranges(rng, 2 * OUT_TILE + 100, max_count=1)
    counts[OUT_TILE // 3] = 0
    lo[OUT_TILE // 3], counts[OUT_TILE // 3] = 0, counts.sum() // 2
    return lo, counts


def _total_of(total):
    def make(rng):
        counts = np.zeros(SEGMENT + 9, dtype=np.int64)
        np.add.at(counts, rng.integers(0, len(counts), total), 1)
        return rng.integers(0, N_BUILD - 64, len(counts)), counts
    return make


def _ranges_of(n_probe):
    return lambda rng: _random_ranges(rng, n_probe)


RANGE_SHAPES = {
    "few": _few, "whole_build_side": _whole_build_side, "triangular": _triangular,
    "one_long_range": _one_long_range, "skewed": _skewed,
    "total_0": _total_of(0), "total_1": _total_of(1),
    "total_out_tile": _total_of(OUT_TILE), "total_out_tile_plus_1": _total_of(OUT_TILE + 1),
    "total_two_out_tiles": _total_of(2 * OUT_TILE),
    "ranges_scan_tile_minus_1": _ranges_of(SCAN_TILE - 1),
    "ranges_scan_tile": _ranges_of(SCAN_TILE),
    "ranges_scan_tile_plus_1": _ranges_of(SCAN_TILE + 1),
    "ranges_segment_minus_1": _ranges_of(SEGMENT - 1),
    "ranges_segment": _ranges_of(SEGMENT),
    "ranges_segment_plus_1": _ranges_of(SEGMENT + 1),
    "ranges_1": _ranges_of(1),
}


def _ranges(shape):
    rng = np.random.default_rng(sorted(RANGE_SHAPES).index(shape) * 53 + 5)
    lo, counts = RANGE_SHAPES[shape](rng)
    return (lo.astype(np.int32), counts.astype(np.int32),
            rng.permutation(N_BUILD).astype(np.int64))


def _pairs_oracle(lo, counts, perm):
    probe = np.repeat(np.arange(len(lo)), counts)
    rows = np.concatenate([perm[a:a + c] for a, c in zip(lo, counts)]
                          + [np.zeros(0, np.int64)])
    return probe, rows


def test_the_range_shapes_are_what_they_claim():
    for shape in RANGE_SHAPES:
        lo, counts, perm = _ranges(shape)
        assert (counts >= 0).all() and (lo >= 0).all(), shape
        assert (lo.astype(np.int64) + counts <= len(perm)).all(), shape
    assert _ranges("few")[1].sum() <= 15 and (_ranges("few")[1] > 0).sum() == 5
    assert _ranges("triangular")[1].sum() == 700 * 699 // 2 > 100 * OUT_TILE
    _, counts, _ = _ranges("skewed")
    assert counts.max() * 3 >= counts.sum() - 2
    for name, total in (("total_0", 0), ("total_1", 1), ("total_out_tile", OUT_TILE),
                        ("total_out_tile_plus_1", OUT_TILE + 1)):
        assert _ranges(name)[1].sum() == total


@pytest.mark.parametrize("shape", sorted(RANGE_SHAPES))
def test_expand_pairs_shapes_match_jax(shape, fastpath):
    lo, counts, perm = _ranges(shape)
    total = int(counts.sum())
    before = (prims.expand_pairs.launches, prims.expand_pairs.rows_seen,
              prims.expand_pairs.pairs_out)
    probe, rows = prims.expand_pairs(_t(lo), _t(counts), _t(perm))
    # CPU: no kernel
    assert before == (prims.expand_pairs.launches, prims.expand_pairs.rows_seen,
                      prims.expand_pairs.pairs_out)
    assert probe.dtype == torch.int64 and rows.dtype == torch.int64
    assert probe.shape == rows.shape == (total,)
    want_probe, want_rows = _pairs_oracle(lo, counts, perm)
    np.testing.assert_array_equal(probe.numpy(), want_probe)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    jp, jb = jax_join._expand_pairs(jnp.asarray(lo), jnp.asarray(counts),
                                    jnp.asarray(perm.astype(np.int32)),
                                    out_cap=max(total, 1))
    np.testing.assert_array_equal(np.asarray(jp)[:total], probe.numpy())
    np.testing.assert_array_equal(np.asarray(jb)[:total], rows.numpy())


@pytest.mark.parametrize("n_probe", [SEGMENT - 1, SCAN_TILE, SCAN_TILE + 1])
def test_expand_pairs_of_views_off_a_16_byte_boundary(n_probe):
    rng = np.random.default_rng(n_probe)
    lo, counts = _random_ranges(rng, n_probe + 1)
    counts = np.minimum(counts, 2)
    perm = rng.permutation(N_BUILD + 1).astype(np.int64)
    whole = [_t(lo.astype(np.int32)), _t(counts.astype(np.int32)), _t(perm)]
    views = [w[1:] for w in whole]
    for w, v in zip(whole, views):
        assert v.is_contiguous() and v.data_ptr() % 16 != w.data_ptr() % 16
    probe, rows = prims.expand_pairs(*views)
    want_probe, want_rows = _pairs_oracle(lo[1:], counts[1:], perm[1:])
    np.testing.assert_array_equal(probe.numpy(), want_probe)
    np.testing.assert_array_equal(rows.numpy(), want_rows)


# -- K4 lookup_last_eq_lut --------------------------------------------------------------


def _lookup_oracle(bk, bvalid, pk, lo, hi):
    last = {}
    for row, (key, ok) in enumerate(zip(bk.tolist(), bvalid.tolist())):
        if ok and lo <= key <= hi:
            last[key] = row
    matched = np.array([k in last for k in pk.tolist()], dtype=bool)
    rows = np.array([last.get(k, 0) for k in pk.tolist()], dtype=np.int64)
    return matched.reshape(len(pk)), rows.reshape(len(pk))


def _check_lookup(bk, bvalid, pk, lo, hi):
    before = (prims.lookup_last_eq_lut.launches, prims.lookup_last_eq_lut.rows_seen)
    args = (_t(bk), _t(bvalid), _t(pk)) if isinstance(bk, np.ndarray) else (bk, bvalid, pk)
    matched, rows = prims.lookup_last_eq_lut(*args, lo, hi)
    # CPU: no kernel
    assert before == (prims.lookup_last_eq_lut.launches, prims.lookup_last_eq_lut.rows_seen)
    assert matched.dtype == torch.bool and rows.dtype == torch.int64
    bk, bvalid, pk = (np.asarray(a) for a in args)
    jm, jr = tpu_prims.lookup_last_eq_lut(jnp.asarray(bk), jnp.asarray(bvalid),
                                          jnp.asarray(pk), lo, hi)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    om, orows = _lookup_oracle(bk, bvalid, pk, lo, hi)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(rows.numpy(), orows)  # the LAST matching row
    return matched


def _keys(seed, nb, nq, lo, hi):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo - 3, hi + 4, nb).astype(np.int64), rng.random(nb) > 0.2,
            rng.integers(lo - 5, hi + 6, nq).astype(np.int64))


@pytest.mark.parametrize("nq", list(range(1, 2 * PROBE_ROWS + 2)))
@pytest.mark.parametrize("nb", [0, 1, 2, 3, 9])
def test_lookup_lut_head_and_tail_lengths_match_jax(nb, nq, fastpath):
    matched = _check_lookup(*_keys(nb * 31 + nq, nb, nq, -2, 6), -2, 6)
    assert matched.shape == (nq,)


def test_lookup_lut_of_views_one_element_into_their_buffers(fastpath):
    bk, bvalid, pk = (_t(a) for a in _keys(3, 258, 1030, -7, 400))
    views = (bk[1:], bvalid[1:], pk[1:])
    assert views[0].data_ptr() % 16 != bk.data_ptr() % 16
    assert views[2].data_ptr() % 16 != pk.data_ptr() % 16
    assert _check_lookup(*views, -7, 400).any()


def test_lookup_lut_every_probe_key_outside_the_range(fastpath):
    bk, bvalid, pk = _keys(4, 200, 777, 0, 50)
    assert not _check_lookup(bk, bvalid, pk + 100, 0, 50).any()


def test_lookup_lut_empty_build_side(fastpath):
    bk, bvalid, pk = _keys(5, 0, 333, 0, 50)
    assert not _check_lookup(bk, bvalid, pk, 0, 50).any()


def test_lookup_lut_every_build_row_invalid(fastpath):
    bk, _, pk = _keys(6, 200, 333, 0, 50)
    assert not _check_lookup(bk, np.zeros(200, dtype=bool), pk, 0, 50).any()


def test_lookup_lut_a_third_of_the_build_rows_on_one_key(fastpath):
    bk, bvalid, pk = _keys(7, 900, 1500, 0, 300)
    hot = np.random.default_rng(7).random(900) < 1 / 3
    bk[hot] = 17
    matched = _check_lookup(bk, bvalid, pk, 0, 300)
    assert matched[pk == 17].all()


def test_lookup_lut_widest_table():
    """A table of LUT_MAX_ENTRIES entries, against the numpy oracle (the
    JAX form is held to the same table size by test_torch_prims.py)."""
    top = join_probe.LUT_MAX_ENTRIES - 1
    rng = np.random.default_rng(8)
    bk = rng.integers(-3, top + 4, 400).astype(np.int64)
    bk[:4] = [0, top, -1, top + 1]
    bvalid = rng.random(400) > 0.2
    bvalid[:4] = True
    pk = np.concatenate([rng.choice(bk, 300), [0, top, -1, top + 1]])
    matched, rows = prims.lookup_last_eq_lut(_t(bk), _t(bvalid), _t(pk), 0, top)
    om, orows = _lookup_oracle(bk, bvalid, pk, 0, top)
    np.testing.assert_array_equal(matched.numpy(), om)
    np.testing.assert_array_equal(rows.numpy(), orows)
    assert matched[-4:].tolist() == [True, True, False, False]


def test_the_wrappers_count_launches_rows_and_pairs():
    for wrapper in (prims.lookup_last_eq_lut, prims.expand_pairs):
        assert isinstance(wrapper.launches, int) and isinstance(wrapper.rows_seen, int)
    assert isinstance(prims.expand_pairs.pairs_out, int)


# -- the build's hash covers included headers ------------------------------------------


def test_every_source_that_includes_the_look_back_header_is_hashed_with_it():
    for name in ("join_probe", "compact"):
        files = [p.name for p in build._source_files(name, build.CSRC_DIR)]
        assert files == [f"{name}.cu", "lookback.cuh"]
    assert [p.name for p in build._source_files("q6_scan", build.CSRC_DIR)] == ["q6_scan.cu"]


@pytest.mark.parametrize("name,rebuilt", [("join_probe", True), ("compact", True),
                                          ("hash_lookup", False)])
def test_a_changed_header_changes_the_library_path(tmp_path, name, rebuilt):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    assert build._library_path(name, csrc) == build._library_path(name)
    header = csrc / "lookback.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert (build._library_path(name, csrc) != build._library_path(name)) is rebuilt
    source = csrc / f"{name}.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert build._library_path(name, csrc) != build._library_path(name)

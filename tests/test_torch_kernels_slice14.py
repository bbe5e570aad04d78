"""The contract that the redesigned capacity kernels must meet: K9c
(compact_indices_cap: select tiles and fill blocks in one launch, no memset
of the output) and K5c (expand_pairs_cap: the expansion writes zeros past
the total itself, the total and the refusal in two words of device memory).

Through the wrappers on CPU tensors (their plain versions) against the JAX
package on the same numpy inputs, run on the CPU: tpu_prims.compact_indices
(mask, cap) in both of its formulations (HYRISE_TPU_FASTPATH) and
hyrise_tpu.ops.join._expand_pairs(lo, counts, build_perm, out_cap), and
against numpy oracles. The first min(count, cap) entries are equal, the rest
of the cap entries are 0, the count is exact (also past cap). The shapes are
the edges of the kernels' designs: capacities at, around and under the
count, a count of 0 under a capacity of 2^20, one row and one entry,
lengths and capacities at multiples of K9's select tile (8,192), K9c's
select tile and fill slice (16,384) and K5's scan tile (16,384) and output
tile (2,048), plus or minus one, odd capacities, one range with a third of
the pairs, and every kind of refused range under a capacity far above the
total. The CUDA kernels are held against these plain versions, at the same
shapes, on the card by chip_smoke.py (phase 3's check_cap_forms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyrise_tpu.kernels import tpu_prims
from hyrise_tpu.ops.join import _expand_pairs as jax_expand_pairs
from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.kernels.compact import compact_indices_cap, compact_indices_cap_plain
from hyrise_tpu_torch.kernels.join_probe import (expand_pairs_cap, expand_pairs_cap_plain,
                                                 expand_pairs_plain)

torch.set_num_threads(1)

K9_TILE = 8192      # compact.cu kTile (K9's select tile)
K9C_TILE = 16384    # compact.cu kCapTile and kFillEntries (K9c)
K5_OUT_TILE = 2048  # join_probe.cu kOutTile
K5_SCAN_TILE = 16384  # join_probe.cu kScanTile


@pytest.fixture(params=["0", "1"], ids=["jax_plain", "jax_fastpath"])
def fastpath(request, monkeypatch):
    monkeypatch.setenv("HYRISE_TPU_FASTPATH", request.param)
    return request.param


def _launches():
    return (compact_indices_cap.launches, expand_pairs_cap.launches,
            dict(build.launch_counts()))


# -- K9c compact_indices_cap -------------------------------------------------------


def _mask(n: int, share: float, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < share


def _check_compact(mask: np.ndarray, cap: int) -> None:
    """The port's capacity form against the JAX package and np.flatnonzero."""
    count = int(mask.sum())
    before = _launches()
    got, got_n = compact_indices_cap(torch.as_tensor(mask), cap)
    assert _launches() == before  # CPU tensors take the plain version
    assert got.shape == (cap,) and got.dtype == torch.int64
    assert got_n.shape == () and got_n.dtype == torch.int64 and int(got_n) == count
    k = min(count, cap)
    want = np.asarray(tpu_prims.compact_indices(jnp.asarray(mask), cap))
    np.testing.assert_array_equal(got.numpy()[:k], want[:k])
    np.testing.assert_array_equal(got.numpy()[:k], np.flatnonzero(mask)[:k])
    assert not got[k:].any()
    plain, plain_n = compact_indices_cap_plain(torch.as_tensor(mask), cap)
    assert torch.equal(plain, got) and int(plain_n) == count


@pytest.mark.parametrize("shift", ["count", "count-1", "count+1", "count//2"])
@pytest.mark.parametrize("n", [20_011, 3 * K9C_TILE + 1])
def test_compact_cap_around_the_count(fastpath, n, shift):
    mask = _mask(n, 0.5, n)
    count = int(mask.sum())
    cap = {"count": count, "count-1": count - 1, "count+1": count + 1,
           "count//2": count // 2}[shift]
    _check_compact(mask, cap)


@pytest.mark.parametrize("cap", [1 << 20, (1 << 20) + 1])
def test_compact_cap_of_a_million_with_nothing_true(fastpath, cap):
    """Every entry is a fill block's: 64 of them zero the whole output."""
    _check_compact(np.zeros(1000, dtype=bool), cap)


@pytest.mark.parametrize("n,true,cap", [(1, True, 1), (1, False, 1), (1, True, 5),
                                        (7, True, 1), (100_003, True, 1)])
def test_compact_cap_one_row_or_one_entry(fastpath, n, true, cap):
    _check_compact(np.full(n, true), cap)


@pytest.mark.parametrize("n", [K9_TILE - 1, K9_TILE, K9_TILE + 1, K9C_TILE - 1, K9C_TILE,
                               K9C_TILE + 1, 2 * K9C_TILE - 1, 2 * K9C_TILE + 1])
@pytest.mark.parametrize("share", [0.5, 1.0])
def test_compact_cap_at_the_tiles(fastpath, n, share):
    """Lengths at the select tiles' edges; with every row True the count
    is n, so the last tile's positions end at its last row."""
    mask = _mask(n, share, n + 1)
    count = int(mask.sum())
    for cap in sorted({count, count + 1, K9C_TILE, 2 * K9C_TILE + 1}):
        _check_compact(mask, cap)


@pytest.mark.parametrize("cap", [K9_TILE - 1, K9_TILE, K9_TILE + 1, K9C_TILE - 1, K9C_TILE,
                                 K9C_TILE + 1, 2 * K9C_TILE - 1, 2 * K9C_TILE,
                                 2 * K9C_TILE + 1])
def test_compact_cap_at_the_fill_slices(fastpath, cap):
    """Capacities at the fill blocks' slices of 16,384 entries, with the
    count inside, at and past the first slice."""
    for n, share in ((40_000, 0.25), (40_000, 0.5), (70_001, 0.5)):
        _check_compact(_mask(n, share, cap + n), cap)


# -- K5c expand_pairs_cap ------------------------------------------------------------


def _ranges(n: int, seed: int, max_count: int = 4):
    """n ranges of 0 to max_count - 1 rows over a build side of n // 4 + 4."""
    rng = np.random.default_rng(seed)
    nb = n // 4 + 4
    counts = np.minimum(rng.integers(0, max_count, n), nb).astype(np.int32)
    lo = (rng.integers(0, nb, n) % (nb - counts + 1)).astype(np.int32)
    return lo, counts, rng.permutation(nb).astype(np.int64)


def _check_expand(lo, counts, perm, cap: int) -> None:
    """The port's capacity form against the JAX package, the exact form and
    a numpy oracle."""
    total = int(counts.astype(np.int64).sum())
    t_lo, t_counts, t_perm = (torch.as_tensor(np.ascontiguousarray(x))
                              for x in (lo, counts, perm))
    before = _launches()
    p, b, got_total, refused = expand_pairs_cap(t_lo, t_counts, t_perm, cap)
    assert _launches() == before
    for out in (p, b):
        assert out.shape == (cap,) and out.dtype == torch.int64
    assert got_total.shape == () and int(got_total) == total
    assert refused.shape == () and refused.dtype == torch.bool and not bool(refused)
    k = min(total, cap)
    jp, jb = jax_expand_pairs(jnp.asarray(lo), jnp.asarray(counts),
                              jnp.asarray(perm, dtype=jnp.int32), cap)
    np.testing.assert_array_equal(p.numpy()[:k], np.asarray(jp)[:k])
    np.testing.assert_array_equal(b.numpy()[:k], np.asarray(jb)[:k])
    probe = np.repeat(np.arange(len(counts)), counts)
    rank = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    np.testing.assert_array_equal(p.numpy()[:k], probe[:k])
    np.testing.assert_array_equal(b.numpy()[:k], perm[(np.repeat(lo, counts) + rank)[:k]])
    assert not p[k:].any() and not b[k:].any()
    exact_p, exact_b = expand_pairs_plain(t_lo, t_counts, t_perm)
    assert torch.equal(p[:k], exact_p[:k]) and torch.equal(b[:k], exact_b[:k])


@pytest.mark.parametrize("shift", ["total", "total-1", "total+1", "total//2"])
@pytest.mark.parametrize("n", [5000, K5_SCAN_TILE + 1])
def test_expand_cap_around_the_total(n, shift):
    lo, counts, perm = _ranges(n, n + 7)
    total = int(counts.sum())
    cap = {"total": total, "total-1": total - 1, "total+1": total + 1,
           "total//2": total // 2}[shift]
    _check_expand(lo, counts, perm, cap)


@pytest.mark.parametrize("cap", [1 << 20, (1 << 20) + 1])
def test_expand_cap_of_a_million_with_no_pair(cap):
    """Every block of the expansion is past the total and writes zeros."""
    lo, _, perm = _ranges(1000, 3)
    _check_expand(lo, np.zeros(1000, dtype=np.int32), perm, cap)


@pytest.mark.parametrize("count,cap", [(1, 1), (0, 1), (1, 2), (3, 1), (3, 3)])
def test_expand_cap_one_range(count, cap):
    _check_expand(np.array([1], dtype=np.int32), np.array([count], dtype=np.int32),
                  np.array([4, 3, 2, 1, 0], dtype=np.int64), cap)


@pytest.mark.parametrize("cap", [K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1,
                                 2 * K5_OUT_TILE - 1, 2 * K5_OUT_TILE + 1, 3 * K5_OUT_TILE,
                                 5 * K5_OUT_TILE + 3])
def test_expand_cap_at_the_output_tiles(cap):
    """Capacities at the expansion's tiles of 2,048 pairs, odd ones among
    them (the last entry alone, not in a 16-byte store), with the total
    inside, at and past the straddling block."""
    for n, seed in ((1500, 1), (3000, 2), (8000, 3)):
        _check_expand(*_ranges(n, cap + seed), cap)


@pytest.mark.parametrize("total", [K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1])
@pytest.mark.parametrize("cap", [4 * K5_OUT_TILE + 1, 1 << 15])
def test_expand_cap_totals_at_a_tile(total, cap):
    """A total at an output tile's edge under a capacity of several tiles:
    the block after the total's writes only zeros."""
    rng = np.random.default_rng(total)
    counts = np.zeros(5000, dtype=np.int32)
    np.add.at(counts, rng.integers(0, 5000, total), 1)
    nb = 1254
    lo = rng.integers(0, nb - 8, 5000).astype(np.int32)
    _check_expand(lo, counts, rng.permutation(nb).astype(np.int64), cap)


@pytest.mark.parametrize("n", [K5_OUT_TILE - 1, K5_OUT_TILE, K5_OUT_TILE + 1,
                               K5_SCAN_TILE - 1, K5_SCAN_TILE, K5_SCAN_TILE + 1])
def test_expand_cap_at_the_range_tiles(n):
    """Range counts at the expansion's chunk of 2,048 ranges and the scan's
    tile of 16,384, with an odd capacity past the total."""
    lo, counts, perm = _ranges(n, n)
    total = int(counts.sum())
    _check_expand(lo, counts, perm, total + 1 + total % 2)


def test_expand_cap_one_range_with_a_third_of_the_pairs():
    lo, counts, perm = _ranges(6000, 11)
    big = int(counts.sum()) // 2
    perm = np.concatenate([perm, np.arange(len(perm), len(perm) + big)])
    lo[2000], counts[2000] = len(perm) - big, big
    total = int(counts.sum())
    for cap in (total, total // 3, total + 2049):
        _check_expand(lo, counts, perm, cap)


BAD_RANGES = {"end past build": ([0, 3], [1, 2]), "negative lo": ([-1, 0], [1, 1]),
              "negative count": ([0, 0], [1, -1]),
              "empty range past build": ([5, 0], [0, 1]),
              "end past int32": ([2**31 - 1, 0], [2**31 - 1, 1])}


@pytest.mark.parametrize("what", sorted(BAD_RANGES))
@pytest.mark.parametrize("cap", [1 << 12, (1 << 20) + 1])
def test_expand_cap_refuses_with_a_large_capacity(what, cap):
    """A refused range sets the flag and leaves every entry of both outputs
    0, however far the capacity reaches past the total; the exact form
    raises on the same ranges."""
    lo, counts = (torch.tensor(x, dtype=torch.int32) for x in BAD_RANGES[what])
    perm = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="outside the build side"):
        expand_pairs_plain(lo, counts, perm)
    p, b, _, refused = expand_pairs_cap(lo, counts, perm, cap)
    assert refused.shape == () and refused.dtype == torch.bool and bool(refused)
    assert p.shape == (cap,) and b.shape == (cap,)
    assert not p.any() and not b.any()


# -- what phase 12 of chip_smoke.py reads: site counts, capacity nodes, census -------


def test_last_counts_hold_every_sites_count():
    """CompiledQuery.last_counts is the count vector the host read: the
    sites' counts in label order (a filter's True rows, a join's pairs),
    then the checks' flags, then the result's rows; a replay's counts on
    the card are the same vector."""
    from hyrise_tpu_torch import ops
    from hyrise_tpu_torch.expression import ast as a
    from hyrise_tpu_torch.plan.compiler import CompiledQuery
    from hyrise_tpu_torch.storage.catalog import Catalog
    from hyrise_tpu_torch.storage.interop import table_from_numpy
    from hyrise_tpu_torch.types import JoinMode

    rng = np.random.default_rng(14)
    f_keys = rng.integers(0, 40, 600).astype(np.int32)
    g_keys = np.repeat(np.arange(40, dtype=np.int32), 3)
    cat = Catalog(device="cpu")
    cat.add_table("f", table_from_numpy("f", [("k", "int32", f_keys, None, None)], 600,
                                        device="cpu"))
    cat.add_table("g", table_from_numpy("g", [("k2", "int32", g_keys, None, None)], 120,
                                        device="cpu"))
    plan = ops.Join(ops.TableScan(ops.GetTable("f", cat), a.col("k") < a.lit(10)),
                    ops.GetTable("g", cat), JoinMode.INNER, ("k", "k2"))
    cq = CompiledQuery(plan, cat)
    assert cq.last_counts == []
    out = cq.run()
    kept = int((f_keys < 10).sum())
    counts = cq.last_counts
    assert len(counts) == len(cq.labels) + 2  # sites, the ranges' check, the rows
    assert counts[cq.labels.index("filter")] == kept
    assert counts[cq.labels.index("join.expand")] == 3 * kept
    assert counts[-2] == 0 and counts[-1] == out.num_rows == 3 * kept


def test_census_classes():
    import chip_smoke

    assert [chip_smoke.pow2_class(v) for v in (0, 1, 2, 3, 1024, 1025)] == [0, 0, 1, 2, 10, 11]
    census = [("K9c", 6_006_330, 1 << 22, 3_000_000), ("K9c", 1000, 1024, 0),
              ("K9c", 1000, 1024, 0), ("K5c", 150_000, 1 << 18, 200_000)]
    line = chip_smoke.census_line(census)
    assert line.startswith("K9c 3 calls, 4196352 entries written, 3000000 of them")
    assert "(10, 10, 0) 2, (23, 22, 22) 1" in line
    assert "K5c 1 calls, 262144 entries written, 200000 of them" in line
    assert "(18, 18, 18) 1" in line


def test_cap_nodes_attribute_kernels_and_the_memsets_before_them():
    """A replay's device events in the order they ran: each capacity call is
    its kernels and the memsets right before them; other kernels and
    memsets are not counted."""
    import types

    import chip_smoke

    cuda = torch.autograd.DeviceType.CUDA
    names = ["Memset (Device)", "lut_build_kernel(long const*)",          # K4's
             "Memset (Device)", "Memset (Device)", "void (anonymous namespace)::select_kernel(x)",
             "Memset (Device)", "(anonymous namespace)::select_cap_kernel(x)",
             "void at::native::index_select_kernel(x)",
             "Memset (Device)", "(anonymous namespace)::ranges_scan_kernel(x)",
             "void (anonymous namespace)::expand_kernel<true>(x)"]
    events = [types.SimpleNamespace(name=name, device_type=cuda,
                                    time_range=types.SimpleNamespace(start=10 * i,
                                                                     end=10 * i + i + 1))
              for i, name in enumerate(names)]
    events.append(types.SimpleNamespace(name="host op", device_type=None,
                                        time_range=types.SimpleNamespace(start=0, end=1000)))
    got = chip_smoke.cap_nodes(types.SimpleNamespace(events=lambda: events[::-1]))
    # K9c: select_kernel (5 us) with two memsets (3 + 4), select_cap_kernel
    # (7) with one (6); K5c: scan (10) with one memset (9), expand (11)
    assert got["K9c"][0] == 2 and got["K9c"][1] == pytest.approx((3 + 4 + 5 + 6 + 7) / 1e3)
    assert got["K5c"][0] == 1 and got["K5c"][1] == pytest.approx((9 + 10 + 11) / 1e3)

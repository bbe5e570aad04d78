"""The join's two device kernels: the direct-address probe (K4) and the pair
expansion (K5), with their plain torch versions and the wrappers of the
hand-written CUDA kernels in csrc/join_probe.cu.

- `lookup_last_eq_lut` (K4) replaces hyrise_tpu/kernels/tpu_prims.py
  lookup_last_eq_lut: the equi-join probe for integer keys whose values are
  known to lie in [key_lo, key_hi]; plain version `lookup_last_eq_lut_plain`.
- `expand_pairs` (K5) replaces hyrise_tpu/ops/join.py _expand_pairs: the
  per-probe-row match ranges over the sorted build side become flat
  (probe row, build row) index pairs; plain version `expand_pairs_plain`.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernels or raises; `launches` counts the calls that
launched, `rows_seen` the probe rows (K4) or ranges (K5) they were given and
K5's `pairs_out` the pairs they made. Each wrapper is one C call: K4's
enqueues the table's memset, the build and the probe; K5's launches the scan
of the counts, takes the total and whether the ranges stay inside the build
side from pinned host memory that the scan's last tile writes (no stream
synchronisation), has the outputs allocated and launches the expansion. Row
ids come out as int64, ready for index_select; the lookup table itself is
int32 (it is the largest allocation of a join).

`expand_pairs_cap` is K5's capacity form (plan/compiler.py; JAX
_expand_pairs(lo, counts, build_perm, out_cap)): cap pairs padded with 0,
the total and the range check's verdict as device tensors, nothing read on
the host, so that a CUDA graph can capture it; plain version
`expand_pairs_cap_plain`. Its C call enqueues a memset of the scratch and
the two kernels, whose expansion writes every output entry once (no memset
of the outputs); the total and the verdict are views of the words the scan
writes, so the wrapper launches no torch op.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hyrise_tpu_torch.kernels import build

# a direct-address table beyond this many entries costs more device memory
# than it saves; such joins take the hash table (kernels/hash_lookup.py)
LUT_MAX_ENTRIES = 1 << 25
# K5's C call asks for its outputs through this: (number of pairs, the two
# output pointers to fill) -> 0, or another value to stop the call
_ALLOCATE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_longlong,
                             ctypes.POINTER(ctypes.c_void_p))
_RANGES_REFUSED = -1
_ALLOCATION_FAILED = -2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("join_probe")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lut_lookup.argtypes = [ptr, ptr, i64, ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
    lib.lut_lookup.restype = i32
    lib.expand_scratch_words.argtypes = [i64]
    lib.expand_scratch_words.restype = i64
    lib.expand_pairs.argtypes = [ptr, ptr, i64, ptr, i64, ptr, _ALLOCATE,
                                 ctypes.POINTER(i64), ptr]
    lib.expand_pairs.restype = i32
    lib.expand_pairs_cap.argtypes = [ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, i64, ptr]
    lib.expand_pairs_cap.restype = i32
    for tile in (lib.expand_scan_tile_rows, lib.expand_out_tile_pairs,
                 lib.expand_stats_words, lib.expand_refused_word):
        tile.argtypes = []
        tile.restype = i32
    return lib


def scan_tile_rows() -> int:
    """Ranges per tile of K5's scan kernel."""
    return _library().expand_scan_tile_rows()


def out_tile_pairs() -> int:
    """Output pairs per block of K5's expansion kernel."""
    return _library().expand_out_tile_pairs()


# -- K4: direct-address equi-join probe -----------------------------------------


def _check_lut(build_keys, build_valid, probe_keys, key_lo: int, key_hi: int) -> int:
    dev = build_keys.device
    build.check_tensor(build_keys, torch.int64, dev, "build_keys")
    build.check_tensor(build_valid, torch.bool, dev, "build_valid")
    build.check_tensor(probe_keys, torch.int64, dev, "probe_keys")
    if build_valid.shape[0] != build_keys.shape[0]:
        raise ValueError("build_valid and build_keys differ in length")
    if build_keys.shape[0] >= 2**31:
        raise ValueError("build row ids do not fit the int32 table")
    size = int(key_hi) - int(key_lo) + 1
    if not 0 < size <= LUT_MAX_ENTRIES:
        raise ValueError(f"key range of {size} entries outside (0, {LUT_MAX_ENTRIES}]")
    if not -2**63 <= int(key_lo) < 2**63:
        raise ValueError(f"key_lo {key_lo} does not fit int64")
    return size


def lookup_last_eq_lut_plain(build_keys: torch.Tensor, build_valid: torch.Tensor,
                             probe_keys: torch.Tensor, key_lo: int, key_hi: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of lookup_last_eq_lut: scatter_reduce_(amax) of
    the build row ids into size + 1 slots (the last takes the skipped
    rows), then one gather per probe row."""
    size = _check_lut(build_keys, build_valid, probe_keys, key_lo, key_hi)
    dev = build_keys.device
    slot = build_keys - key_lo
    slot = torch.where(build_valid & (slot >= 0) & (slot < size), slot, size)
    rows = torch.arange(build_keys.shape[0], dtype=torch.int32, device=dev)
    lut = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    lut.scatter_reduce_(0, slot, rows, reduce="amax")
    p = probe_keys - key_lo
    inside = (p >= 0) & (p < size)
    row = lut[:size][p.clamp(0, size - 1)].to(torch.int64)
    matched = inside & (row >= 0)
    return matched, torch.where(matched, row, 0)


def lookup_last_eq_lut(build_keys: torch.Tensor, build_valid: torch.Tensor,
                       probe_keys: torch.Tensor, key_lo: int, key_hi: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each probe key: (matched, build row). `matched` (bool) says some
    valid build row carries an equal key; the row (int64) is the LAST such
    row, the one with the highest id, and 0 where nothing matched.

    Keys are int64; every build key that should be found lies in
    [key_lo, key_hi], a range of at most LUT_MAX_ENTRIES values. Invalid
    build rows and build keys outside the range are skipped, probe keys
    outside it match nothing. CPU tensors take lookup_last_eq_lut_plain;
    CUDA tensors launch the K4 kernels (table fill, build and probe from one
    C call)."""
    size = _check_lut(build_keys, build_valid, probe_keys, key_lo, key_hi)
    dev = build_keys.device
    if dev.type == "cpu":
        return lookup_last_eq_lut_plain(build_keys, build_valid, probe_keys,
                                        key_lo, key_hi)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb, nq = build_keys.shape[0], probe_keys.shape[0]
    matched = torch.empty(nq, dtype=torch.bool, device=dev)
    rows = torch.empty(nq, dtype=torch.int64, device=dev)
    if nq == 0:
        return matched, rows
    table = torch.empty(size, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().lut_lookup(
            build_keys.data_ptr(), build_valid.view(torch.uint8).data_ptr(), nb,
            probe_keys.data_ptr(), nq, int(key_lo), size, table.data_ptr(),
            matched.view(torch.uint8).data_ptr(), rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "lut_lookup")
    build.count_launch(lookup_last_eq_lut, rows_seen=nq)
    return matched, rows


lookup_last_eq_lut.launches = 0
lookup_last_eq_lut.rows_seen = 0


# -- K5: pair expansion ---------------------------------------------------------


def _check_ranges(lo, counts, build_perm) -> None:
    dev = lo.device
    build.check_tensor(lo, torch.int32, dev, "lo")
    build.check_tensor(counts, torch.int32, dev, "counts")
    build.check_tensor(build_perm, torch.int64, dev, "build_perm")
    if lo.shape[0] != counts.shape[0]:
        raise ValueError("lo and counts differ in length")


def _ranges_refused(min_count: int, min_lo: int, min_end: int, max_end: int,
                    n_build: int) -> ValueError:
    """What is raised for a negative count or a range (an empty one too)
    outside build_perm's n_build rows."""
    return ValueError(f"ranges outside the build side: least count {min_count}, "
                      f"least lo {min_lo}, ends {min_end} to {max_end} of "
                      f"{n_build} build rows")


def _ends_and_total(lo, counts, build_perm) -> Tuple[torch.Tensor, int]:
    """Inclusive prefix sum of counts (int64) and its total, read on the
    host in one transfer together with the ranges' bounds, which are
    checked."""
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    if lo.shape[0] == 0:
        return ends, 0
    # int32 throughout: an end past 2^31 wraps below 0 and fails the check
    min_end, max_end = torch.aminmax(lo + counts)
    total, *bounds = torch.stack(
        [ends[-1], counts.min(), lo.min(), min_end, max_end]).tolist()
    if min(bounds[:3]) < 0 or bounds[3] > build_perm.shape[0]:
        raise _ranges_refused(*bounds, build_perm.shape[0])
    return ends, total


def expand_pairs_plain(lo: torch.Tensor, counts: torch.Tensor,
                       build_perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of expand_pairs: repeat_interleave of the probe
    row ids and rank arithmetic on the exclusive prefix sum."""
    _check_ranges(lo, counts, build_perm)
    ends, total = _ends_and_total(lo, counts, build_perm)
    counts64 = counts.to(torch.int64)
    probe = torch.repeat_interleave(
        torch.arange(lo.shape[0], dtype=torch.int64, device=lo.device), counts64,
        output_size=total)
    offsets = ends - counts64
    rank = torch.arange(probe.shape[0], dtype=torch.int64, device=lo.device) \
        - offsets.index_select(0, probe)
    pos = lo.to(torch.int64).index_select(0, probe) + rank
    return probe, build_perm.index_select(0, pos)


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor,
                 build_perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (probe row, build row) pairs, int64 each, of the ranges
    [lo[p], lo[p] + counts[p]) over the sorted build side: probe-major, and
    within a probe row in the build side's sorted order;
    build row = build_perm[position]. `lo` and `counts` are int32 (counts
    non-negative, every range inside build_perm), `build_perm` int64. Rows
    with a zero count own no output.

    A negative count or a range outside build_perm raises ValueError before
    any pair is written. CPU tensors take expand_pairs_plain. CUDA tensors
    launch the K5 kernels from one C call: the scan of the counts, whose
    total and bounds reach the host without a stream synchronisation, then
    the expansion into outputs allocated in between; no pair launches no
    expansion, no range launches nothing."""
    _check_ranges(lo, counts, build_perm)
    dev = lo.device
    if dev.type == "cpu":
        return expand_pairs_plain(lo, counts, build_perm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_probe = lo.shape[0]
    if n_probe == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, torch.empty_like(empty)
    lib = _library()
    scratch = torch.empty(lib.expand_scratch_words(n_probe), dtype=torch.int64, device=dev)
    outputs, failure = [], []

    def allocate(total, pointers):
        try:
            outputs.extend(torch.empty(total, dtype=torch.int64, device=dev)
                           for _ in range(2))
        except Exception as exc:  # an exception cannot cross the C call: kept, raised below
            failure.append(exc)
            return 1
        pointers[0], pointers[1] = outputs[0].data_ptr(), outputs[1].data_ptr()
        return 0

    stats = (ctypes.c_longlong * 5)()
    with torch.cuda.device(dev):
        err = lib.expand_pairs(lo.data_ptr(), counts.data_ptr(), n_probe,
                               build_perm.data_ptr(), build_perm.shape[0],
                               scratch.data_ptr(), _ALLOCATE(allocate), stats,
                               torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(max(err, 0), "expand_pairs")
    if err == _ALLOCATION_FAILED:
        raise failure[0]
    if err == _RANGES_REFUSED:
        build.count_launch(expand_pairs, rows_seen=n_probe)
        raise _ranges_refused(*stats[1:], build_perm.shape[0])
    build.count_launch(expand_pairs, rows_seen=n_probe, pairs_out=stats[0])
    return outputs[0], outputs[1]


expand_pairs.launches = 0
expand_pairs.rows_seen = 0
expand_pairs.pairs_out = 0


# -- K5, the capacity form ------------------------------------------------------


def expand_pairs_cap_plain(lo: torch.Tensor, counts: torch.Tensor, build_perm: torch.Tensor,
                           cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain torch version of expand_pairs_cap: the inclusive prefix sum of
    the counts, and per output position its range by searchsorted and its
    rank by subtraction; no host read."""
    _check_ranges(lo, counts, build_perm)
    if cap < 1:
        raise ValueError(f"capacity {cap} < 1")
    dev = lo.device
    n_probe, n_build = lo.shape[0], build_perm.shape[0]
    zeros = torch.zeros(cap, dtype=torch.int64, device=dev)
    if n_probe == 0:
        none = torch.zeros((), dtype=torch.int64, device=dev)
        return zeros, zeros.clone(), none, none.to(torch.bool)
    counts64 = counts.to(torch.int64)
    ends = torch.cumsum(counts64, 0)
    total = ends[-1]
    # int32 ends, as the kernel and expand_pairs_plain take them
    min_end, max_end = torch.aminmax(lo + counts)
    refused = ((counts.min() < 0) | (lo.min() < 0) | (min_end < 0)
               | (max_end.to(torch.int64) > n_build))
    n_out = torch.where(refused, 0, total.clamp(max=cap))
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    kept = pos < n_out
    probe = torch.searchsorted(ends, pos, right=True).clamp(max=n_probe - 1)
    rank = pos - (ends - counts64).index_select(0, probe)
    at = (lo.to(torch.int64).index_select(0, probe) + rank).clamp(0, max(n_build - 1, 0))
    build_rows = build_perm.index_select(0, at) if n_build else zeros
    return (torch.where(kept, probe, 0), torch.where(kept, build_rows, 0), total, refused)


def expand_pairs_cap(lo: torch.Tensor, counts: torch.Tensor, build_perm: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probe rows, build rows, total, refused): the first min(total, cap)
    pairs of expand_pairs in order, then 0 up to cap entries each; the
    number of pairs the ranges make (int64, 0-dim, may exceed cap); and
    whether a count is negative or a range leaves build_perm (bool, 0-dim;
    then no pair is written). CPU tensors take expand_pairs_cap_plain; CUDA
    tensors launch the K5 kernels' capacity form (a memset of the scratch,
    the scan, the expansion; no host wait) or raise."""
    _check_ranges(lo, counts, build_perm)
    dev = lo.device
    if dev.type == "cpu":
        return expand_pairs_cap_plain(lo, counts, build_perm, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cap < 1:
        raise ValueError(f"capacity {cap} < 1")
    n_probe = lo.shape[0]
    # the build rows start 16-byte aligned: an odd cap gets one more column
    outputs = torch.empty((2, cap + cap % 2), dtype=torch.int64, device=dev)
    if n_probe == 0:
        outputs.zero_()
        none = torch.zeros((), dtype=torch.int64, device=dev)
        return outputs[0, :cap], outputs[1, :cap], none, none.to(torch.bool)
    lib = _library()
    scratch = torch.empty(lib.expand_scratch_words(n_probe) + lib.expand_stats_words(),
                          dtype=torch.int64, device=dev)
    stats = scratch[-lib.expand_stats_words():]
    with torch.cuda.device(dev):
        err = lib.expand_pairs_cap(lo.data_ptr(), counts.data_ptr(), n_probe,
                                   build_perm.data_ptr(), build_perm.shape[0],
                                   scratch.data_ptr(), stats.data_ptr(),
                                   outputs[0].data_ptr(), outputs[1].data_ptr(), cap,
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "expand_pairs_cap")
    build.count_launch(expand_pairs_cap, rows_seen=n_probe)
    # the verdict's word holds 0 or 1: its lowest byte, as a bool
    at = lib.expand_refused_word()
    refused = stats[at:at + 1].view(torch.bool)[0]
    return outputs[0, :cap], outputs[1, :cap], stats[0], refused


expand_pairs_cap.launches = 0
expand_pairs_cap.rows_seen = 0

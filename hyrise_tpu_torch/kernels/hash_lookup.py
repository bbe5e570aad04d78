"""The equi-join lookup for keys of any range (K8): the plain torch version
and the wrapper of the hand-written CUDA kernels in csrc/hash_lookup.cu.

Port of the general form of hyrise_tpu/kernels/tpu_prims.py lookup_last_eq:
for every probe key, whether some valid build row carries an equal key, and
the LAST such row. It serves the joins the direct-address table (K4) cannot:
composite or unbounded integer keys, float keys, and the row hashes of
Difference. Keys compare by value: -0.0 equals 0.0, a NaN equals nothing.

`lookup_last_eq` takes `lookup_last_eq_plain` only for tensors on the CPU.
For CUDA tensors it launches the kernels or raises; `launches` counts the
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.kernels.compact import compact_indices

_BLOCKS_PER_SM = 8


def _check(build_keys, build_valid, probe_keys) -> None:
    dev = build_keys.device
    if build_keys.dtype not in (torch.int64, torch.float64):
        raise TypeError(f"keys must be int64 or float64, got {build_keys.dtype}")
    build.check_tensor(build_keys, build_keys.dtype, dev, "build_keys")
    build.check_tensor(build_valid, torch.bool, dev, "build_valid")
    build.check_tensor(probe_keys, build_keys.dtype, dev, "probe_keys")
    if build_valid.shape[0] != build_keys.shape[0]:
        raise ValueError("build_valid and build_keys differ in length")
    if build_keys.shape[0] >= 2**31:
        raise ValueError("build row ids do not fit the int32 table")


def lookup_last_eq_plain(build_keys: torch.Tensor, build_valid: torch.Tensor,
                         probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of lookup_last_eq: one stable sort of the valid
    build rows and two binary searches per probe row."""
    _check(build_keys, build_valid, probe_keys)
    if build_keys.is_floating_point():
        build_valid = build_valid & ~torch.isnan(build_keys)
    rows = compact_indices(build_valid)
    sorted_keys, order = torch.sort(build_keys.index_select(0, rows), stable=True)
    perm = rows.index_select(0, order)
    lo = torch.searchsorted(sorted_keys, probe_keys, right=False)
    hi = torch.searchsorted(sorted_keys, probe_keys, right=True)
    matched = hi > lo
    if probe_keys.is_floating_point():
        matched = matched & ~torch.isnan(probe_keys)
    if perm.shape[0] == 0:
        return matched, torch.zeros_like(probe_keys, dtype=torch.int64)
    # the stable sort keeps equal keys in row order: the last is at hi - 1
    row = perm.index_select(0, (hi - 1).clamp(min=0))
    return matched, torch.where(matched, row, 0)


def table_slots(nb: int) -> int:
    """Slots of K8's table for nb build rows: two a row and two more. Even
    (two 16-byte slots to a 32-byte sector), more than nb (a probe sequence
    always meets an empty slot) and at a load of at most a half. PERF.md
    section 6 has the table sizes that were timed before two was chosen."""
    return 2 * nb + 2


def filter_bits(nb: int) -> int:
    """Bits of the filter in front of K8's table: a power of two, 8 to 16 a
    build row (at least 32), so that a probe key that is not in the table
    finds its bit clear at least 7 times in 8 and reads no slot."""
    return 1 << max(5, (8 * nb - 1).bit_length())


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("hash_lookup")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hash_lookup.argtypes = [ptr, ptr, i64, ptr, i64, i32, ptr, i64, i64, ptr,
                                ptr, i32, i32, ptr]
    lib.hash_lookup.restype = i32
    for shape in (lib.hash_threads_per_block, lib.hash_probe_rows_per_thread):
        shape.argtypes = []
        shape.restype = i32
    return lib


def lookup_last_eq(build_keys: torch.Tensor, build_valid: torch.Tensor,
                   probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each probe key: (matched, build row). `matched` (bool) says some
    valid build row carries an equal key; the row (int64) is the LAST such
    row, the one with the highest id, and 0 where nothing matched. Keys are
    int64 or float64 (both sides alike); an empty build side matches
    nothing. CPU tensors take lookup_last_eq_plain; CUDA tensors launch the
    K8 kernels (table clear, build and probe from one C call)."""
    _check(build_keys, build_valid, probe_keys)
    dev = build_keys.device
    if dev.type == "cpu":
        return lookup_last_eq_plain(build_keys, build_valid, probe_keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb, nq = build_keys.shape[0], probe_keys.shape[0]
    matched = torch.empty(nq, dtype=torch.bool, device=dev)
    rows = torch.empty(nq, dtype=torch.int64, device=dev)
    if nq == 0:
        return matched, rows
    lib = _library()
    slots, bits = table_slots(nb), filter_bits(nb)
    # 16 bytes a slot, one slot behind the table, then the filter
    table = torch.empty(2 * (slots + 1) + -(-bits // 64), dtype=torch.int64, device=dev)
    threads = lib.hash_threads_per_block()
    build_blocks = build.grid_blocks(nb, threads, _BLOCKS_PER_SM, dev)
    probe_blocks = build.grid_blocks(-(-nq // lib.hash_probe_rows_per_thread()), threads,
                                     _BLOCKS_PER_SM, dev)
    with torch.cuda.device(dev):
        err = lib.hash_lookup(
            build_keys.data_ptr(), build_valid.view(torch.uint8).data_ptr(), nb,
            probe_keys.data_ptr(), nq, int(build_keys.is_floating_point()),
            table.data_ptr(), slots, bits, matched.view(torch.uint8).data_ptr(),
            rows.data_ptr(), build_blocks, probe_blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "hash_lookup")
    build.count_launch(lookup_last_eq)
    return matched, rows


lookup_last_eq.launches = 0

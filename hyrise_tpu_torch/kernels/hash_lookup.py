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
_EMPTY_KEY = -(1 << 63)  # the bit pattern 0x8000000000000000 as an int64


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("hash_lookup")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hash_build.argtypes = [ptr, i32, ptr, i64, ptr, ptr, i64, i32, ptr]
    lib.hash_build.restype = i32
    lib.hash_probe.argtypes = [ptr, i32, i64, ptr, ptr, i64, ptr, ptr, i32, ptr]
    lib.hash_probe.restype = i32
    lib.hash_threads_per_block.argtypes = []
    lib.hash_threads_per_block.restype = i32
    return lib


def lookup_last_eq(build_keys: torch.Tensor, build_valid: torch.Tensor,
                   probe_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each probe key: (matched, build row). `matched` (bool) says some
    valid build row carries an equal key; the row (int64) is the LAST such
    row, the one with the highest id, and 0 where nothing matched. Keys are
    int64 or float64 (both sides alike); an empty build side matches
    nothing. CPU tensors take lookup_last_eq_plain; CUDA tensors launch the
    K8 kernels (table build, then probe)."""
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
    capacity = 1 << max(1, (2 * nb - 1).bit_length())  # power of two >= 2 * nb
    slot_keys = torch.full((capacity,), _EMPTY_KEY, dtype=torch.int64, device=dev)
    slot_rows = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    is_float = int(build_keys.is_floating_point())
    threads = lib.hash_threads_per_block()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nb:
            err = lib.hash_build(
                build_keys.data_ptr(), is_float,
                build_valid.view(torch.uint8).data_ptr(), nb, slot_keys.data_ptr(),
                slot_rows.data_ptr(), capacity,
                build.grid_blocks(nb, threads, _BLOCKS_PER_SM, dev), stream)
            build.check_launch(err, "hash_build")
        err = lib.hash_probe(
            probe_keys.data_ptr(), is_float, nq, slot_keys.data_ptr(),
            slot_rows.data_ptr(), capacity, matched.view(torch.uint8).data_ptr(),
            rows.data_ptr(), build.grid_blocks(nq, threads, _BLOCKS_PER_SM, dev),
            stream)
    build.check_launch(err, "hash_probe")
    lookup_last_eq.launches += 1
    return matched, rows


lookup_last_eq.launches = 0

"""Reduction over sorted segments (K7): the plain torch version and the
wrapper of the hand-written CUDA kernel in csrc/segment_reduce.cu.

Port of hyrise_tpu/kernels/tpu_prims.py segment_sums_sorted, widened to
what the general group-by (ops/aggregate.py `_general`) needs: once the rows
are in group order, group g is rows [starts[g], starts[g + 1]) of that
order, and per group one call gives the number of valid inputs and their
sum, minimum or maximum. The gather into group order (`rows`) and the NULL
mask (`validity`) happen inside the kernel.

`segment_reduce_sorted` takes `segment_reduce_sorted_plain` only for tensors
on the CPU. For CUDA tensors it launches the kernel or raises; `launches`
counts the launches. No atomics: a group's values are folded in row order
by one thread (a float64 sum then equals the sequential sum) or, where
groups average 32 rows or more, by the 32 lanes of one warp in a fixed
order; either way equal inputs give equal bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.kernels.group_reduce import extreme

_BLOCKS_PER_SM = 8
# groups of at least this many rows on average get a warp each, not a thread
_WARP_GROUP_ROWS = 32
_OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}
_VALUE_TYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}


def _acc_dtype(values: torch.Tensor) -> torch.dtype:
    return torch.float64 if values.is_floating_point() else torch.int64


def _check(values, starts, kind, rows, validity) -> None:
    if kind not in _OPS:
        raise ValueError(f"unknown reduction {kind!r}")
    dev = starts.device
    build.check_tensor(starts, torch.int64, dev, "starts")
    if starts.shape[0] < 1:
        raise ValueError("starts needs n_groups + 1 entries")
    if rows is not None:
        build.check_tensor(rows, torch.int64, dev, "rows")
    if validity is not None:
        build.check_tensor(validity, torch.bool, dev, "validity")
    if kind == "count":
        return
    if values is None or values.dtype not in _VALUE_TYPES:
        raise TypeError(f"{kind} needs float64/float32/int64/int32 values, got "
                        f"{None if values is None else values.dtype}")
    build.check_tensor(values, values.dtype, dev, "values")
    if validity is not None and validity.shape[0] != values.shape[0]:
        raise ValueError("validity and values differ in length")


def segment_reduce_sorted_plain(values: Optional[torch.Tensor], starts: torch.Tensor,
                                kind: str, rows: Optional[torch.Tensor] = None,
                                validity: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of segment_reduce_sorted: group ids by
    repeat_interleave, then bincount, index_add_ or scatter_reduce_ into
    n_groups + 1 slots (the last takes the NULL inputs)."""
    _check(values, starts, kind, rows, validity)
    dev = starts.device
    n_groups = starts.shape[0] - 1
    sizes = starts[1:] - starts[:-1]
    n = int(starts[-1] - starts[0]) if n_groups else 0
    gid = torch.repeat_interleave(torch.arange(n_groups, dtype=torch.int64, device=dev),
                                  sizes, output_size=n)
    if rows is None:
        first = int(starts[0]) if n_groups else 0
        rows = torch.arange(first, first + n, dtype=torch.int64, device=dev)
    else:
        rows = rows[int(starts[0]):int(starts[0]) + n] if n_groups else rows[:0]
    if validity is not None:
        gid = torch.where(validity.index_select(0, rows), gid, n_groups)
    n_valid = torch.bincount(gid, minlength=n_groups + 1)[:n_groups]
    if kind == "count":
        return n_valid, n_valid
    d = values.index_select(0, rows)
    if kind == "sum":
        out = torch.zeros(n_groups + 1, dtype=_acc_dtype(values), device=dev)
        return out.index_add_(0, gid, d.to(out.dtype))[:n_groups], n_valid
    out = torch.full((n_groups + 1,), extreme(values.dtype, kind == "min"),
                     dtype=values.dtype, device=dev)
    out.scatter_reduce_(0, gid, d, reduce="amin" if kind == "min" else "amax")
    return out[:n_groups], n_valid


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("segment_reduce")
    ptr, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_double)
    lib.segment_reduce_sorted.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i32, f64,
                                          i64, ptr, ptr, i32, i32, ptr]
    lib.segment_reduce_sorted.restype = i32
    lib.segment_threads_per_block.argtypes = []
    lib.segment_threads_per_block.restype = i32
    return lib


def segment_reduce_sorted(values: Optional[torch.Tensor], starts: torch.Tensor,
                          kind: str, rows: Optional[torch.Tensor] = None,
                          validity: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(result, valid inputs) per group, n_groups = len(starts) - 1 entries
    each. Group g is positions [starts[g], starts[g + 1]) of the group
    order (starts is int64 and ascending); position j stands for row
    rows[j] (int64), or row j itself without `rows`; a row enters where
    `validity` (bool, indexed by row like `values`) holds, or always
    without it. Every named row must lie inside `values`.

    kind 'sum': float64 for float values, exact int64 for integers, 0 for a
    group without valid input. 'min' / 'max': in the values' dtype, the
    dtype's extreme for such a group. 'count': the result is the valid
    count itself; `values` may be None. CPU tensors take
    segment_reduce_sorted_plain; CUDA tensors launch the K7 kernel."""
    _check(values, starts, kind, rows, validity)
    dev = starts.device
    if dev.type == "cpu":
        return segment_reduce_sorted_plain(values, starts, kind, rows, validity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_groups = starts.shape[0] - 1
    is_count = kind == "count"
    is_extremum = kind in ("min", "max")
    n_valid = torch.empty(n_groups, dtype=torch.int64, device=dev)
    acc = torch.int64 if is_count else _acc_dtype(values)
    out = n_valid if is_count else torch.empty(n_groups, dtype=acc, device=dev)
    if n_groups == 0:
        return (out.to(values.dtype) if is_extremum else out), n_valid
    sentinel = extreme(values.dtype, kind == "min") if is_extremum else 0
    lib = _library()
    # the rows in all groups, as far as the arguments' lengths tell
    given = rows if rows is not None else (values if values is not None else validity)
    warp_per_group = given is not None and \
        given.shape[0] >= _WARP_GROUP_ROWS * n_groups
    threads = lib.segment_threads_per_block()
    blocks = build.grid_blocks(n_groups, threads // 32 if warp_per_group else threads,
                               _BLOCKS_PER_SM, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_reduce_sorted(
            None if is_count else values.data_ptr(),
            0 if is_count else _VALUE_TYPES[values.dtype],
            None if rows is None else rows.data_ptr(),
            None if validity is None else validity.view(torch.uint8).data_ptr(),
            starts.data_ptr(), n_groups, _OPS[kind],
            float(sentinel) if acc is torch.float64 else 0.0,
            int(sentinel) if acc is torch.int64 else 0,
            None if is_count else out.data_ptr(), n_valid.data_ptr(), blocks,
            int(warp_per_group), stream)
    build.check_launch(err, "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    return (out.to(values.dtype) if is_extremum else out), n_valid


segment_reduce_sorted.launches = 0

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
counts the calls that launched and `rows_seen` the positions they covered.
The kernel balances its work over tiles of consecutive positions of the
group order, not over groups, so one form serves every distribution of group
sizes. No atomics touch a result, so equal inputs give equal bits on every
launch. A float64 sum is the sequential sum in position order for a short
group inside one tile, and otherwise a fixed tree of sequential partial sums
whose shape depends only on `starts` (csrc/segment_reduce.cu says how).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.kernels.group_reduce import extreme

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
    lib.segment_reduce_sorted.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i64, i32, f64,
                                          i64, ptr, ptr, ptr, i64, ptr]
    lib.segment_reduce_sorted.restype = i32
    lib.segment_tile_positions.argtypes = []
    lib.segment_tile_positions.restype = i32
    lib.segment_scratch_words.argtypes = [i64]
    lib.segment_scratch_words.restype = i64
    return lib


@functools.cache
def tile_positions() -> int:
    """Positions of the group order that one block of the kernel owns."""
    return _library().segment_tile_positions()


def segment_reduce_sorted(values: Optional[torch.Tensor], starts: torch.Tensor,
                          kind: str, rows: Optional[torch.Tensor] = None,
                          validity: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(result, valid inputs) per group, n_groups = len(starts) - 1 entries
    each. Group g is positions [starts[g], starts[g + 1]) of the group
    order (starts is int64 and ascending); position j stands for row
    rows[j] (int64), or row j itself without `rows`; a row enters where
    `validity` (bool, indexed by row like `values`) holds, or always
    without it. Every named row must lie inside `values`, and every position
    inside `rows` (without `rows`: inside `values`).

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
    # The positions lie in [0, n_positions): the length of `rows`, or of the
    # column that positions index directly. A count without validity reads
    # no position.
    given = rows if rows is not None else (values if values is not None else validity)
    n_positions = 0 if given is None else given.shape[0]
    scratch = None
    tiles = max(1, -(-n_positions // tile_positions()))
    if not (is_count and validity is None):
        scratch = torch.empty(lib.segment_scratch_words(tiles), dtype=torch.int64,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_reduce_sorted(
            None if is_count else values.data_ptr(),
            0 if is_count else _VALUE_TYPES[values.dtype],
            None if rows is None else rows.data_ptr(),
            None if validity is None else validity.view(torch.uint8).data_ptr(),
            starts.data_ptr(), n_groups, n_positions, _OPS[kind],
            float(sentinel) if acc is torch.float64 else 0.0,
            int(sentinel) if acc is torch.int64 else 0,
            None if is_count else out.data_ptr(), n_valid.data_ptr(),
            None if scratch is None else scratch.data_ptr(), tiles, stream)
    build.check_launch(err, "segment_reduce_sorted")
    build.count_launch(segment_reduce_sorted, rows_seen=n_positions)
    return (out.to(values.dtype) if is_extremum else out), n_valid


segment_reduce_sorted.launches = 0
segment_reduce_sorted.rows_seen = 0

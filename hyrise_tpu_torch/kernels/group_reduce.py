"""Group reduce into at most 64 dense cells (K3): the plain torch version and
the wrapper of the hand-written CUDA kernel in csrc/group_reduce.cu.

Port of hyrise_tpu/kernels/tpu_prims.py segment_reduce_cells. It carries the
aggregate tiers for global and low-cardinality group-bys (ops/aggregate.py):
`cell` names each row's group, and rows whose cell lies outside
[0, n_cells) (dead rows, NULL inputs) take no part.

`segment_reduce_cells` takes `segment_reduce_cells_plain` only for tensors
on the CPU. For CUDA tensors it launches the kernel or raises; `launches`
counts the launches. The kernel uses no atomics and folds in a fixed order,
so equal inputs give equal bits on every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from hyrise_tpu_torch.kernels import build

# group spaces at most this large take the dense-cell aggregate tiers
DENSE_CELL_MAX = 64
# dynamic shared memory one SM can give its resident blocks, in bytes
_SHARED_PER_SM = 227 * 1024
_MAX_BLOCKS_PER_SM = 8

_OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}
_VALUE_TYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}


def _acc_dtype(values: Optional[torch.Tensor]) -> torch.dtype:
    if values is not None and values.is_floating_point():
        return torch.float64
    return torch.int64


def _check(values, cell, n_cells: int, kind: str, sentinel) -> None:
    if kind not in _OPS:
        raise ValueError(f"unknown reduction {kind!r}")
    if not 1 <= n_cells <= DENSE_CELL_MAX:
        raise ValueError(f"n_cells {n_cells} outside [1, {DENSE_CELL_MAX}]")
    build.check_tensor(cell, torch.int32, cell.device, "cell")
    if kind == "count":
        return
    if values is None or values.dtype not in _VALUE_TYPES:
        raise TypeError(f"{kind} needs float64/float32/int64/int32 values, got "
                        f"{None if values is None else values.dtype}")
    build.check_tensor(values, values.dtype, cell.device, "values")
    if values.shape[0] != cell.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {cell.shape[0]} cells")
    if kind in ("min", "max") and sentinel is None:
        raise ValueError(f"{kind} needs the sentinel an empty cell takes")


def segment_reduce_cells_plain(values: Optional[torch.Tensor], cell: torch.Tensor,
                               n_cells: int, kind: str, sentinel=None) -> torch.Tensor:
    """Plain torch version of segment_reduce_cells (index_add_, bincount and
    scatter_reduce_ into n_cells + 1 slots, the last one taking every row
    that is outside the cell space)."""
    _check(values, cell, n_cells, kind, sentinel)
    slot = torch.where((cell >= 0) & (cell < n_cells), cell, n_cells).to(torch.int64)
    if kind == "count":
        return torch.bincount(slot, minlength=n_cells + 1)[:n_cells]
    if kind == "sum":
        out = torch.zeros(n_cells + 1, dtype=_acc_dtype(values), device=cell.device)
        return out.index_add_(0, slot, values.to(out.dtype))[:n_cells]
    out = torch.full((n_cells + 1,), sentinel, dtype=values.dtype, device=cell.device)
    return out.scatter_reduce_(0, slot, values,
                               reduce="amin" if kind == "min" else "amax")[:n_cells]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("group_reduce")
    ptr, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_double)
    lib.group_reduce.argtypes = [ptr, i32, ptr, i64, i32, i32, f64, i64, ptr,
                                 ptr, i32, ptr]
    lib.group_reduce.restype = i32
    for fn in (lib.group_reduce_threads_per_block, lib.group_reduce_rows_per_step,
               lib.group_reduce_max_cells):
        fn.argtypes = []
        fn.restype = i32
    if lib.group_reduce_max_cells() != DENSE_CELL_MAX:
        raise RuntimeError("csrc/group_reduce.cu and DENSE_CELL_MAX disagree")
    return lib


def segment_reduce_cells(values: Optional[torch.Tensor], cell: torch.Tensor,
                         n_cells: int, kind: str, sentinel=None) -> torch.Tensor:
    """out[c] = the `kind` of values[i] over the rows with cell[i] == c, for
    c in [0, n_cells); rows with a cell outside that range are ignored.

    kind: 'sum' (float64 for float values, int64 for integer values; 0 for
    an empty cell), 'count' (int64 rows per cell; `values` is not read and
    may be None), 'min' / 'max' (in the values' dtype; `sentinel` for an
    empty cell). `cell` is int32; n_cells is at most DENSE_CELL_MAX.
    CPU tensors take segment_reduce_cells_plain; CUDA tensors launch the K3
    kernel."""
    _check(values, cell, n_cells, kind, sentinel)
    dev = cell.device
    if dev.type == "cpu":
        return segment_reduce_cells_plain(values, cell, n_cells, kind, sentinel)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc = _acc_dtype(values)
    is_extremum = kind in ("min", "max")
    n = cell.shape[0]
    if n == 0:
        fill = sentinel if is_extremum else 0
        return torch.full((n_cells,), fill, device=dev,
                          dtype=values.dtype if is_extremum else acc)
    lib = _library()
    shared = n_cells * lib.group_reduce_threads_per_block() * 8
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM, _SHARED_PER_SM // shared))
    rows_per_block = (lib.group_reduce_threads_per_block()
                      * lib.group_reduce_rows_per_step())
    blocks = build.grid_blocks(n, rows_per_block, per_sm, dev)
    partials = torch.empty(blocks * n_cells, dtype=acc, device=dev)
    out = torch.empty(n_cells, dtype=acc, device=dev)
    init_f = float(sentinel) if is_extremum and acc is torch.float64 else 0.0
    init_i = int(sentinel) if is_extremum and acc is torch.int64 else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.group_reduce(
            None if kind == "count" else values.data_ptr(),
            0 if kind == "count" else _VALUE_TYPES[values.dtype],
            cell.data_ptr(), n, n_cells, _OPS[kind], init_f, init_i,
            partials.data_ptr(), out.data_ptr(), blocks, stream)
    build.check_launch(err, "group_reduce")
    segment_reduce_cells.launches += 1
    return out.to(values.dtype) if is_extremum else out


segment_reduce_cells.launches = 0

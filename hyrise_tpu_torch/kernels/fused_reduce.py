"""Fused filter + dense-cell aggregate (K6): the plain torch version and the
wrapper of the hand-written CUDA kernel in csrc/fused_reduce.cu.

Port of the traced `compute` of hyrise_tpu/kernels/fused.py
(FusedFilterAggregate._build). From a row mask, the group-by columns'
dictionary codes and a list of aggregate inputs, one pass over the rows
gives the row count per cell and, per aggregate input, (sum | min | max |
count, number of valid inputs) per cell. A row's cell is the mixed-radix
number of its codes; rows the mask leaves out take no part.

`fused_cells_reduce` takes `fused_cells_reduce_plain` only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises; `launches`
counts the launches. No atomics, a fixed fold order: equal inputs give equal
bits on every call.

Two rules size a launch. `launch_shape` picks its tile (8 or 4 rows a
thread) and, above 8 cells, its folders (the threads with private
accumulators): a block stages two tiles of every column it reads (mask,
code columns, validity columns, distinct value columns) and keeps n_acc *
n_cells accumulators for each of its 8 warps (up to 8 cells) or folders,
n_acc = 1 (the row count) + the distinct validity columns + the distinct
(value column, fold) pairs, and the first shape that leaves room for two
blocks an SM is taken. `plan_launches` splits the slots over several
launches where even the smallest shape exceeds one block's 227 KB, or a
launch would exceed the kernel's 16 slots, each launch counting rows and the
validities its own slots need. Each launch is one kernel and no memset, its
result and partials in one buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.kernels import build
from hyrise_tpu_torch.kernels.group_reduce import (DENSE_CELL_MAX, extreme,
                                                   segment_reduce_cells_plain)

# the limits compiled into csrc/fused_reduce.cu (checked when it is loaded)
MAX_KEYS = 8
MAX_SLOTS = 16
# the launch shape of csrc/cells_reduce.cuh: 256 threads (8 warps) a block,
# at most 8 blocks an SM (2,048 threads), 8 or 4 rows a thread a tile, 128,
# 64 or 32 folders above 8 cells
WARPS = 8
THREADS = 32 * WARPS
_MAX_BLOCKS_PER_SM = 8
_ROWS = (8, 4)
_FOLDERS = (128, 64, 32)
# shared memory of one block (227 KB) and of an SM (228 KB); each resident
# block also takes 1 KB of the SM's
SHARED_BYTES = 227 * 1024
_TWO_BLOCKS = 228 * 1024 // 2 - 1024

_FOLDS = {"sum": 0, "min": 1, "max": 2}
_VALUE_TYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}

# (values, validity or None, kind): kind is 'sum', 'min', 'max' or 'count'
# ('count' reads no values; they may be None)
Slot = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], str]


def _check(mask, keys, sizes, slots) -> int:
    """Validate the arguments; returns the number of cells."""
    dev = mask.device
    build.check_tensor(mask, torch.bool, dev, "mask")
    n = mask.shape[0]
    if len(keys) != len(sizes) or len(keys) > MAX_KEYS:
        raise ValueError(f"{len(keys)} key columns, {len(sizes)} sizes; at most {MAX_KEYS}")
    n_cells = 1
    for k, size in zip(keys, sizes):
        build.check_tensor(k, torch.int32, dev, "key codes")
        if k.shape[0] != n or size < 1:
            raise ValueError("key column length or size does not fit the mask")
        n_cells *= int(size)
    if not 1 <= n_cells <= DENSE_CELL_MAX:
        raise ValueError(f"{n_cells} cells outside [1, {DENSE_CELL_MAX}]")
    for values, validity, kind in slots:
        if kind != "count" and kind not in _FOLDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        if validity is not None:
            build.check_tensor(validity, torch.bool, dev, "validity")
            if validity.shape[0] != n:
                raise ValueError("validity length does not fit the mask")
        if kind == "count":
            continue
        if values is None or values.dtype not in _VALUE_TYPES:
            raise TypeError(f"{kind} needs float64/float32/int64/int32 values, got "
                            f"{None if values is None else values.dtype}")
        build.check_tensor(values, values.dtype, dev, "values")
        if values.shape[0] != n:
            raise ValueError("values length does not fit the mask")
    return n_cells


def fused_cells_reduce_plain(mask: torch.Tensor, keys: Sequence[torch.Tensor],
                             sizes: Sequence[int], slots: Sequence[Slot]):
    """Plain torch version of fused_cells_reduce: the cell column is built
    with one `where`, and every count and fold is one reduction of
    segment_reduce_cells_plain."""
    n_cells = _check(mask, keys, sizes, slots)
    cell = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    for k, size in zip(keys, sizes):
        cell = cell * size + k
    cell = torch.where(mask, cell, n_cells)
    counts = segment_reduce_cells_plain(None, cell, n_cells, "count")
    out = []
    for values, validity, kind in slots:
        cell_s = cell if validity is None else torch.where(validity, cell, n_cells)
        n_valid = counts if validity is None else \
            segment_reduce_cells_plain(None, cell_s, n_cells, "count")
        if kind == "count":
            out.append((n_valid, n_valid))
            continue
        sentinel = None if kind == "sum" else extreme(values.dtype, kind == "min")
        out.append((segment_reduce_cells_plain(values, cell_s, n_cells, kind, sentinel),
                    n_valid))
    return counts, out


def max_blocks(n: int, sms: int, tile_rows: int) -> int:
    """The most blocks a launch over n rows may take, and so the partials
    its buffer holds: one a tile, at most _MAX_BLOCKS_PER_SM an SM. The C
    side takes fewer where the SM's occupancy holds fewer."""
    return max(1, min(-(-n // tile_rows), sms * _MAX_BLOCKS_PER_SM))


def shared_bytes(column_bytes: Sequence[int], n_entries: int, rows_per_thread: int = 8,
                 width: int = WARPS) -> int:
    """Dynamic shared memory of a block (csrc/cells_reduce.cuh
    shared_bytes): the launch's job (1,280 bytes), two stages of a tile of
    every column (each a 16-byte chunk longer, for a column that starts
    inside a chunk), n_entries accumulators of `width` (the 8 warps, or the
    folders), the tile's cell bytes, a flag word and the two stages'
    barriers."""
    tile = rows_per_thread * THREADS
    stage = sum(tile * b + 16 for b in column_bytes)
    return 1280 + 2 * stage + n_entries * width * 8 + tile + 16 + 16


def launch_shape(column_bytes: Sequence[int], n_acc: int, n_cells: int,
                 rows_options: Sequence[int] = _ROWS) -> Tuple[int, int, int]:
    """(rows a thread, folders, shared bytes) of a launch that stages
    columns of `column_bytes` and keeps n_acc accumulators a cell: the
    first shape, in the order folders (128, 64, 32; 0 up to 8 cells, which
    fold in registers), rows a thread (`rows_options`), of which two blocks
    fit an SM; else the smallest, one block an SM."""
    folders_options = _FOLDERS if n_cells > 8 else (0,)
    for folders in folders_options:
        for rows in rows_options:
            shared = shared_bytes(column_bytes, n_acc * n_cells, rows, folders or WARPS)
            if shared <= _TWO_BLOCKS:
                return rows, folders, shared
    rows, folders = rows_options[-1], folders_options[-1]
    return rows, folders, shared_bytes(column_bytes, n_acc * n_cells, rows, folders or WARPS)


def plan_launches(n_cells: int, items: Sequence[Tuple[int, int]],
                  fixed: Sequence[int] = ()) -> List[Tuple[int, List[int]]]:
    """Split accumulator work over launches: [(shared bytes of a block at 4
    rows a thread, item numbers)]. An item is (value bytes, validity column
    number or -1): a fold of a value column of that element size, or, with
    0 bytes, a validity column of which only the count is wanted. `fixed`
    lists the element bytes of the columns every launch reads (mask, code
    columns). A launch stages its fixed columns, one byte per validity
    column its items name and its items' value columns, and keeps its row
    count, those validities' counts and its folds for every cell
    (launch_shape). Items join the current launch while its
    shape at 4 rows a thread fits one block's shared memory and the kernel's
    slot limits."""
    def shared(validities, values):
        return launch_shape([*fixed, *([1] * len(validities)), *values],
                            1 + len(validities) + len(values), n_cells, _ROWS[-1:])[2]

    def fits(validities, values):
        return (shared(validities, values) <= SHARED_BYTES
                and len(values) <= MAX_SLOTS and len(validities) <= MAX_SLOTS)

    groups: List[Tuple[set, List[int], List[int]]] = [(set(), [], [])]
    for number, (value_bytes, validity) in enumerate(items):
        used, values, members = groups[-1]
        grown = used | ({validity} if validity >= 0 else set())
        more = values + ([value_bytes] if value_bytes else [])
        if members and not fits(grown, more):
            members = []
            groups.append((set(), [], members))
            grown = {validity} if validity >= 0 else set()
            more = [value_bytes] if value_bytes else []
        if not fits(grown, more):
            raise ValueError(f"one aggregate over {n_cells} cells does not fit "
                             "a block's shared memory")
        members.append(number)
        groups[-1] = (grown, more, members)
    return [(shared(used, values), members) for used, values, members in groups]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("fused_reduce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_cells_reduce.argtypes = [ptr, i32, ptr, ptr, i32, ptr, i32, ptr, ptr, i32,
                                       ptr, ptr, ptr, i64, i32, ptr, ptr, i32, i32, i32, ptr]
    lib.fused_cells_reduce.restype = i32
    lib.fused_shared_bytes.argtypes = [i32, ptr, i32, i32, i32]
    lib.fused_shared_bytes.restype = i32
    for fn, want in ((lib.fused_max_keys, MAX_KEYS), (lib.fused_max_slots, MAX_SLOTS),
                     (lib.fused_max_cells, DENSE_CELL_MAX),
                     (lib.fused_max_shared, SHARED_BYTES), (lib.fused_warps, WARPS)):
        fn.argtypes = []
        fn.restype = i32
        if fn() != want:
            raise RuntimeError("csrc/fused_reduce.cu and fused_reduce.py disagree "
                               "on a limit")
    for column_bytes, n_entries, shape in (([1, 4, 4, 4, 4, 4, 4], 42, (4, 8)),
                                           ([8] * 5, 640, (8, 64))):
        if lib.fused_shared_bytes(len(column_bytes), _ints(column_bytes), n_entries,
                                  *shape) != shared_bytes(column_bytes, n_entries, *shape):
            raise RuntimeError("csrc/cells_reduce.cuh and fused_reduce.shared_bytes "
                               "disagree")
    lib.fused_init.argtypes = []
    lib.fused_init.restype = i32
    build.check_launch(lib.fused_init(), "fused_init")
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * max(len(values), 1))(*values)


def _launch(lib, mask, keys, sizes, n_cells: int, validities: List[torch.Tensor],
            folds: List[Tuple[torch.Tensor, str, int]]) -> torch.Tensor:
    """One kernel launch: int64 [1 + validities + folds, n_cells] (float
    accumulators as their bits), a view of the one buffer that also holds
    the blocks' partials."""
    dev = mask.device
    n = mask.shape[0]
    n_entries = (1 + len(validities) + len(folds)) * n_cells
    values: List[torch.Tensor] = []  # distinct value columns, staged once each
    for v, _, _ in folds:
        if not any(v is w for w in values):
            values.append(v)
    rows, folders, _ = launch_shape(
        [1] + [4] * len(keys) + [1] * len(validities) + [v.element_size() for v in values],
        1 + len(validities) + len(folds), n_cells, _ROWS)
    blocks = max_blocks(n, build.sm_count(dev), rows * THREADS)
    buffer = torch.empty(n_entries * (1 + blocks), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_cells_reduce(
            mask.view(torch.uint8).data_ptr(), len(keys), _pointers(keys),
            _ints([int(s) for s in sizes]), len(validities),
            _pointers([v.view(torch.uint8) for v in validities]), len(values),
            _pointers(values), _ints([_VALUE_TYPES[v.dtype] for v in values]), len(folds),
            _ints([next(i for i, w in enumerate(values) if w is f[0]) for f in folds]),
            _ints([_FOLDS[f[1]] for f in folds]), _ints([f[2] for f in folds]),
            n, n_cells, buffer.data_ptr(), build.ticket(dev, "fused_reduce").data_ptr(),
            blocks, rows, folders, stream)
    build.check_launch(err, "fused_cells_reduce")
    build.count_launch(fused_cells_reduce)
    return buffer[:n_entries].view(-1, n_cells)


def fused_cells_reduce(mask: torch.Tensor, keys: Sequence[torch.Tensor],
                       sizes: Sequence[int], slots: Sequence[Slot]):
    """(rows per cell, [(result, valid inputs) per slot]), every tensor of
    n_cells entries, n_cells = the product of `sizes` (1 without keys).

    mask: bool (n,), the rows that take part. keys: int32 code columns with
    codes in [0, size). slots: (values, validity, kind) per aggregate input;
    a row enters a slot where mask and validity (None: all valid) hold.
    'sum' gives float64 for float values and exact int64 for integers (0
    for an empty cell); 'min'/'max' come in the values' dtype (the dtype's
    extreme for an empty cell); 'count' gives the valid inputs and reads no
    values. Slots that name the same tensors share one accumulator. CPU
    tensors take fused_cells_reduce_plain; CUDA tensors launch the K6
    kernel, in as many launches as plan_launches says."""
    n_cells = _check(mask, keys, sizes, slots)
    dev = mask.device
    if dev.type == "cpu":
        return fused_cells_reduce_plain(mask, keys, sizes, slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    validities: List[torch.Tensor] = []   # distinct validity columns
    folds: List[Tuple[torch.Tensor, str, int]] = []  # distinct (values, kind, validity)
    slot_validity, slot_fold = [], []
    for values, validity, kind in slots:
        v = -1
        if validity is not None:
            v = next((i for i, t in enumerate(validities) if t is validity), -1)
            if v < 0:
                validities.append(validity)
                v = len(validities) - 1
        f = -1
        if kind != "count":
            f = next((i for i, (t, k, fv) in enumerate(folds)
                      if t is values and k == kind and fv == v), -1)
            if f < 0:
                folds.append((values, kind, v))
                f = len(folds) - 1
        slot_validity.append(v)
        slot_fold.append(f)
    items = [(values.element_size(), v) for values, _, v in folds]
    folded = {v for _, _, v in folds}
    items += [(0, v) for v in range(len(validities)) if v not in folded]

    lib = _library()
    counts = None
    valid_counts = {}
    fold_out = {}
    for _, members in plan_launches(n_cells, items, [1] + [4] * len(keys)):
        used = sorted({items[m][1] for m in members if items[m][1] >= 0})
        local = {v: i for i, v in enumerate(used)}
        launch_folds = [m for m in members if items[m][0]]
        out = _launch(lib, mask, keys, sizes, n_cells, [validities[v] for v in used],
                      [(folds[m][0], folds[m][1], local.get(folds[m][2], -1))
                       for m in launch_folds])
        counts = out[0] if counts is None else counts
        for v, i in local.items():
            valid_counts[v] = out[1 + i]
        for i, m in enumerate(launch_folds):
            fold_out[m] = out[1 + len(used) + i]

    results = []
    for (values, _, kind), v, f in zip(slots, slot_validity, slot_fold):
        n_valid = counts if v < 0 else valid_counts[v]
        if kind == "count":
            results.append((n_valid, n_valid))
            continue
        r = fold_out[f]
        if values.is_floating_point():
            r = r.view(torch.float64)
        if kind != "sum":
            # the kernel folds in int64 / float64 from that type's extreme: an
            # empty cell takes the input dtype's instead, as in the plain version
            r = torch.where(n_valid > 0, r.to(values.dtype),
                            extreme(values.dtype, kind == "min"))
        results.append((r, n_valid))
    return counts, results


fused_cells_reduce.launches = 0

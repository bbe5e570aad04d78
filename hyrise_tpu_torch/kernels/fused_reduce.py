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

One rule sizes a launch (`plan_launches`). Every thread of a block owns
n_acc * n_cells 8-byte accumulators in shared memory, n_acc = 1 (the row
count) + the distinct validity columns + the distinct (value column, fold)
pairs. The block takes the most threads of 256, 128, 64, 32 whose
accumulators fit one block's 227 KB; where 32 do not fit, or a launch
would exceed the kernel's 16 slots, the slots are split over several
launches, each counting rows and the validities its own slots need.
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
SHARED_BYTES = 227 * 1024
_THREAD_CHOICES = (256, 128, 64, 32)
_MAX_BLOCKS_PER_SM = 8

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


def plan_launches(n_cells: int, items: Sequence[Tuple[bool, int]]
                  ) -> List[Tuple[int, List[int]]]:
    """Split accumulator work over launches: [(threads per block, item
    numbers)]. An item is (has a fold, validity column number or -1): a fold
    slot, or a validity column of which only the count is wanted. A launch's
    accumulators are its row count, one count per validity column its items
    name, and its folds. Items join the current launch while its
    accumulators fit one block's shared memory at 32 threads and the
    kernel's slot limits; then the launch takes the most threads that fit."""
    def n_acc(validities, folds):
        return 1 + len(validities) + folds

    def fits(validities, folds, threads=_THREAD_CHOICES[-1]):
        return (n_acc(validities, folds) * n_cells * threads * 8 <= SHARED_BYTES
                and folds <= MAX_SLOTS and len(validities) <= MAX_SLOTS)

    groups: List[Tuple[set, int, List[int]]] = [(set(), 0, [])]
    for number, (has_fold, validity) in enumerate(items):
        used, folds, members = groups[-1]
        grown = used | ({validity} if validity >= 0 else set())
        if members and not fits(grown, folds + has_fold):
            used, folds, members = set(), 0, []
            groups.append((used, folds, members))
            grown = {validity} if validity >= 0 else set()
        if not fits(grown, folds + has_fold):
            raise ValueError(f"one aggregate over {n_cells} cells does not fit "
                             "a block's shared memory")
        members.append(number)
        groups[-1] = (grown, folds + has_fold, members)
    return [(next(t for t in _THREAD_CHOICES if fits(used, folds, t)), members)
            for used, folds, members in groups]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("fused_reduce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_cells_reduce.argtypes = [ptr, i32, ptr, ptr, i32, ptr, i32, ptr, ptr,
                                       ptr, ptr, i64, i32, i32, i32, ptr, ptr, ptr]
    lib.fused_cells_reduce.restype = i32
    for fn, want in ((lib.fused_max_keys, MAX_KEYS), (lib.fused_max_slots, MAX_SLOTS),
                     (lib.fused_max_cells, DENSE_CELL_MAX),
                     (lib.fused_max_shared, SHARED_BYTES)):
        fn.argtypes = []
        fn.restype = i32
        if fn() != want:
            raise RuntimeError("csrc/fused_reduce.cu and fused_reduce.py disagree "
                               "on a limit")
    return lib


def _launch(lib, mask, keys, sizes, n_cells: int, validities: List[torch.Tensor],
            folds: List[Tuple[torch.Tensor, str, int]], threads: int) -> torch.Tensor:
    """One kernel launch: int64 [1 + validities + folds, n_cells] (float
    accumulators as their bits)."""
    dev = mask.device
    n = mask.shape[0]
    n_acc = 1 + len(validities) + len(folds)
    shared = n_acc * n_cells * threads * 8
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM, SHARED_BYTES // shared))
    blocks = build.grid_blocks(n, threads, per_sm, dev)
    partials = torch.empty(blocks * n_acc * n_cells, dtype=torch.int64, device=dev)
    out = torch.empty((n_acc, n_cells), dtype=torch.int64, device=dev)

    def pointers(tensors):
        return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])

    def ints(values):
        return (ctypes.c_int * max(len(values), 1))(*values)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_cells_reduce(
            mask.view(torch.uint8).data_ptr(), len(keys), pointers(keys),
            ints([int(s) for s in sizes]), len(validities),
            pointers([v.view(torch.uint8) for v in validities]), len(folds),
            pointers([f[0] for f in folds]),
            ints([_VALUE_TYPES[f[0].dtype] for f in folds]),
            ints([_FOLDS[f[1]] for f in folds]), ints([f[2] for f in folds]),
            n, n_cells, threads, blocks, partials.data_ptr(), out.data_ptr(), stream)
    build.check_launch(err, "fused_cells_reduce")
    fused_cells_reduce.launches += 1
    return out


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
    items = [(True, v) for _, _, v in folds]
    folded = {v for _, _, v in folds}
    items += [(False, v) for v in range(len(validities)) if v not in folded]

    lib = _library()
    counts = None
    valid_counts = {}
    fold_out = {}
    for threads, members in plan_launches(n_cells, items):
        used = sorted({items[m][1] for m in members if items[m][1] >= 0})
        local = {v: i for i, v in enumerate(used)}
        launch_folds = [m for m in members if items[m][0]]
        out = _launch(lib, mask, keys, sizes, n_cells, [validities[v] for v in used],
                      [(folds[m][0], folds[m][1], local.get(folds[m][2], -1))
                       for m in launch_folds], threads)
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

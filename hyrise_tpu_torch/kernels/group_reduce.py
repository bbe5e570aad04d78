"""Group reduce into at most 64 dense cells (K3): the plain torch versions and
the wrappers of the hand-written CUDA kernel in csrc/group_reduce.cu.

Port of hyrise_tpu/kernels/tpu_prims.py segment_reduce_cells. It carries the
aggregate tiers for global and low-cardinality group-bys (ops/aggregate.py):
`cell` names each row's group, and rows whose cell lies outside
[0, n_cells) (dead rows, NULL inputs) take no part.

`segment_reduce_cells_many` computes every reduction of an Aggregate in one
pass: the row count per cell, and per slot (values, validity, kind) its
result and its valid rows. `segment_reduce_cells` is its one-slot call. Both
take their plain versions only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise. `segment_reduce_cells.launches` counts every
launch of the kernel, whichever of the two made it.

A launch is one kernel and no memset, its results and the blocks' partials
in one buffer, every result a view of it (no torch op follows the kernel). Its grid and each row's place in the fold depend only on n
and the cells, so a slot gives the same bits alone, batched with other slots
or split over launches, and on every call. `plan_launches` splits the slots
over several launches where one launch would exceed the kernel's 16 folds or
16 validity columns, or accumulators that leave room for two blocks an SM.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from hyrise_tpu_torch.kernels import build

# group spaces at most this large take the dense-cell aggregate tiers
DENSE_CELL_MAX = 64
# the limits compiled into csrc/group_reduce.cu (checked when it is loaded)
MAX_FOLDS = 16
MAX_VALIDITIES = 16
THREADS = 256
WARPS = THREADS // 32
BLOCKS_PER_SM = 3  # the blocks an SM that csrc/group_reduce.cu's registers leave room for
# shared memory two blocks may each take on one SM (228 KB, 1 KB a block kept)
_TWO_BLOCKS = 228 * 1024 // 2 - 1024

_OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}
_VALUE_TYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}

# (values, validity or None, kind): kind is 'sum', 'min', 'max' or 'count'
# ('count' reads no values; they may be None)
Slot = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], str]


def extreme(dtype: torch.dtype, for_min: bool):
    """The identity of MIN (or MAX) in `dtype`: what a reduction over no
    rows gives."""
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _acc_dtype(values: Optional[torch.Tensor]) -> torch.dtype:
    if values is not None and values.is_floating_point():
        return torch.float64
    return torch.int64


def _check_cells(cell, n_cells: int) -> None:
    if not 1 <= n_cells <= DENSE_CELL_MAX:
        raise ValueError(f"n_cells {n_cells} outside [1, {DENSE_CELL_MAX}]")
    build.check_tensor(cell, torch.int32, cell.device, "cell")


def _check_slot(values, validity, cell, kind: str) -> None:
    if kind not in _OPS:
        raise ValueError(f"unknown reduction {kind!r}")
    if validity is not None:
        build.check_tensor(validity, torch.bool, cell.device, "validity")
        if validity.shape[0] != cell.shape[0]:
            raise ValueError(f"{validity.shape[0]} validity flags for {cell.shape[0]} cells")
    if kind == "count":
        return
    if values is None or values.dtype not in _VALUE_TYPES:
        raise TypeError(f"{kind} needs float64/float32/int64/int32 values, got "
                        f"{None if values is None else values.dtype}")
    build.check_tensor(values, values.dtype, cell.device, "values")
    if values.shape[0] != cell.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {cell.shape[0]} cells")


def _check(values, cell, n_cells: int, kind: str, sentinel) -> None:
    _check_cells(cell, n_cells)
    _check_slot(values, None, cell, kind)
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


def segment_reduce_cells_many_plain(cell: torch.Tensor, n_cells: int,
                                    slots: Sequence[Slot]):
    """Plain torch version of segment_reduce_cells_many: one
    segment_reduce_cells_plain a count and a slot, a slot's validity moving
    its invalid rows outside the cell space."""
    _check_cells(cell, n_cells)
    for values, validity, kind in slots:
        _check_slot(values, validity, cell, kind)
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


def shared_bytes(n_cells: int, n_validities: int, n_folds: int) -> int:
    """Dynamic shared memory of a block (csrc/group_reduce.cu shared_bytes):
    a 16-byte flag, the accumulators (the row count, the validity counts and
    the folds of every cell, 8 bytes each; a row a thread up to 8 cells, a
    row a warp above) and a byte a thread a validity column."""
    rows = THREADS if n_cells <= 8 else WARPS
    return 16 + rows * 8 * (1 + n_validities + n_folds) * n_cells + n_validities * THREADS


def tile_rows(n_cells: int) -> int:
    """Rows a block takes at a time: 2,048 up to 8 cells, 1,024 above."""
    return THREADS * (8 if n_cells <= 8 else 4)


def launch_blocks(n: int, n_cells: int, sms: int) -> int:
    """The grid of a launch over n rows: one block a tile, at most
    BLOCKS_PER_SM an SM (fewer may be resident at once; the rest wait). It
    depends on n and n_cells alone, so every launch over the same rows folds
    them in the same order."""
    return max(1, min(-(-n // tile_rows(n_cells)), sms * BLOCKS_PER_SM))


def plan_launches(n_cells: int, items: Sequence[Tuple[bool, int]]) -> List[List[int]]:
    """Split accumulator work over launches: the item numbers of each launch.
    An item is (folds, validity): a fold of a value column (folds True) that
    takes the rows of validity column `validity` (-1: every row), or
    (False, v) the count of validity column v alone. A launch counts its
    rows, the validity columns its items name and keeps its folds; items
    join the current launch while it stays within MAX_FOLDS folds,
    MAX_VALIDITIES validity columns and shared memory for two blocks an
    SM."""
    def fits(validities, folds):
        return (folds <= MAX_FOLDS and len(validities) <= MAX_VALIDITIES
                and shared_bytes(n_cells, len(validities), folds) <= _TWO_BLOCKS)

    launches: List[List[int]] = [[]]
    used, folds = set(), 0
    for number, (is_fold, validity) in enumerate(items):
        grown = used | ({validity} if validity >= 0 else set())
        more = folds + (1 if is_fold else 0)
        if launches[-1] and not fits(grown, more):
            launches.append([])
            grown = {validity} if validity >= 0 else set()
            more = 1 if is_fold else 0
        if not fits(grown, more):
            raise ValueError(f"one reduction over {n_cells} cells does not fit a launch")
        launches[-1].append(number)
        used, folds = grown, more
    return launches


def _ints(values, ctype=ctypes.c_int):
    return (ctype * max(len(values), 1))(*values)


def _pointers(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(*[t.data_ptr() for t in tensors])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("group_reduce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.group_reduce_cells.argtypes = [ptr, i64, i32, i32, ptr, i32, ptr, ptr, ptr, ptr,
                                       ptr, ptr, ptr, i32, ptr]
    lib.group_reduce_cells.restype = i32
    lib.group_reduce_shared_bytes.argtypes = [i32, i32, i32]
    lib.group_reduce_shared_bytes.restype = i32
    for fn, want in ((lib.group_reduce_threads_per_block, THREADS),
                     (lib.group_reduce_max_cells, DENSE_CELL_MAX),
                     (lib.group_reduce_max_folds, MAX_FOLDS),
                     (lib.group_reduce_max_validities, MAX_VALIDITIES)):
        fn.argtypes = []
        fn.restype = i32
        if fn() != want:
            raise RuntimeError("csrc/group_reduce.cu and group_reduce.py disagree on a limit")
    lib.group_reduce_tile_rows.argtypes = [i32]
    lib.group_reduce_tile_rows.restype = i32
    if any(lib.group_reduce_tile_rows(k) != tile_rows(k) for k in (1, 8, 9, 64)):
        raise RuntimeError("csrc/group_reduce.cu and group_reduce.tile_rows disagree")
    for n_cells, n_validities, n_folds in ((6, 0, 4), (64, 3, 5)):
        if lib.group_reduce_shared_bytes((1 + n_validities + n_folds) * n_cells,
                                         n_validities, n_cells) != \
                shared_bytes(n_cells, n_validities, n_folds):
            raise RuntimeError("csrc/group_reduce.cu and group_reduce.shared_bytes disagree")
    lib.group_reduce_init.argtypes = []
    lib.group_reduce_init.restype = i32
    build.check_launch(lib.group_reduce_init(), "group_reduce_init")
    return lib


def _init_bits(values: torch.Tensor, kind: str, sentinel) -> int:
    """The start of a fold as the kernel takes it: 0 for a sum, else the
    sentinel in the values' dtype, as the bits of a float64 (float values)
    or an int64."""
    if kind == "sum":
        return 0
    if values.is_floating_point():
        wide = float(torch.tensor(sentinel, dtype=values.dtype))
        return struct.unpack("<q", struct.pack("<d", wide))[0]
    return int(sentinel)


def _launch(lib, cell, n_cells: int, validities: List[torch.Tensor],
            folds: List[Tuple[torch.Tensor, str, int, int]]) -> torch.Tensor:
    """One kernel launch: int64 [1 + validities + folds, n_cells] (float
    accumulators as their bits), a view of the one buffer that also holds
    the blocks' partials. A fold is (values, kind, validity number or -1,
    start bits)."""
    dev = cell.device
    n = cell.shape[0]
    n_entries = (1 + len(validities) + len(folds)) * n_cells
    blocks = launch_blocks(n, n_cells, build.sm_count(dev))
    buffer = torch.empty(n_entries * (1 + (blocks if blocks > 1 else 0)), dtype=torch.int64,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.group_reduce_cells(
            cell.data_ptr(), n, n_cells, len(validities),
            _pointers([v.view(torch.uint8) for v in validities]), len(folds),
            _pointers([f[0] for f in folds]), _ints([_VALUE_TYPES[f[0].dtype] for f in folds]),
            _ints([_OPS[f[1]] for f in folds]), _ints([f[2] for f in folds]),
            _ints([f[3] for f in folds], ctypes.c_longlong), buffer.data_ptr(),
            build.ticket(dev, "group_reduce").data_ptr(), blocks, stream)
    build.check_launch(err, "group_reduce_cells")
    build.count_launch(segment_reduce_cells)
    return buffer[:n_entries].view(-1, n_cells)


def _reduce(cell: torch.Tensor, n_cells: int, slots):
    """The kernel's launches for slots (values, validity, kind, sentinel):
    (rows per cell, [(result, valid inputs) per slot]). Slots that name the
    same tensors, kind and sentinel share one accumulator, and each distinct
    validity column is counted once."""
    validities: List[torch.Tensor] = []
    folds: List[Tuple[torch.Tensor, str, int, int]] = []  # (values, kind, validity, bits)
    slot_validity, slot_fold = [], []
    for values, validity, kind, sentinel in slots:
        v = -1
        if validity is not None:
            v = next((i for i, t in enumerate(validities) if t is validity), -1)
            if v < 0:
                validities.append(validity)
                v = len(validities) - 1
        f = -1
        if kind != "count":
            bits = _init_bits(values, kind, sentinel)
            f = next((i for i, (t, k, fv, b) in enumerate(folds)
                      if t is values and k == kind and fv == v and b == bits), -1)
            if f < 0:
                folds.append((values, kind, v, bits))
                f = len(folds) - 1
        slot_validity.append(v)
        slot_fold.append(f)
    items = [(True, v) for _, _, v, _ in folds]
    folded = {v for _, _, v, _ in folds}
    items += [(False, v) for v in range(len(validities)) if v not in folded]

    lib = _library()
    counts, valid_counts, fold_out = None, {}, {}
    for members in plan_launches(n_cells, items):
        used = sorted({items[m][1] for m in members if items[m][1] >= 0})
        local = {v: i for i, v in enumerate(used)}
        launch_folds = [m for m in members if items[m][0]]
        out = _launch(lib, cell, n_cells, [validities[v] for v in used],
                      [(folds[m][0], folds[m][1], local.get(folds[m][2], -1), folds[m][3])
                       for m in launch_folds])
        counts = out[0] if counts is None else counts
        for v, i in local.items():
            valid_counts[v] = out[1 + i]
        for i, m in enumerate(launch_folds):
            fold_out[m] = out[1 + len(used) + i]

    results = []
    for (values, _, kind, _), v, f in zip(slots, slot_validity, slot_fold):
        n_valid = counts if v < 0 else valid_counts[v]
        if kind == "count":
            results.append((n_valid, n_valid))
            continue
        r = fold_out[f]
        if kind != "sum" and values.element_size() == 4:
            # the kernel writes a float32 or int32 min or max in that type,
            # in the low half of its 8-byte entry
            r = r.view(values.dtype)[::2]
        elif values.is_floating_point():
            r = r.view(torch.float64)
        results.append((r, n_valid))
    return counts, results


def segment_reduce_cells_many(cell: torch.Tensor, n_cells: int, slots: Sequence[Slot]):
    """(rows per cell, [(result, valid inputs) per slot]), every tensor of
    n_cells entries: out[c] over the rows with cell[i] == c, for c in [0,
    n_cells); rows with a cell outside that range take no part.

    slots: (values, validity, kind) per reduction; a row enters a slot where
    its validity (bool; None: every row) holds. 'sum' gives float64 for
    float values and exact int64 for integers (0 for an empty cell);
    'min' / 'max' come in the values' dtype (the dtype's extreme for an
    empty cell); 'count' gives the valid inputs and reads no values. Slots
    that name the same tensors share one accumulator. `cell` is int32;
    n_cells is at most DENSE_CELL_MAX. CPU tensors take
    segment_reduce_cells_many_plain; CUDA tensors launch the K3 kernel, once
    unless plan_launches splits the slots."""
    _check_cells(cell, n_cells)
    for values, validity, kind in slots:
        _check_slot(values, validity, cell, kind)
    dev = cell.device
    if dev.type == "cpu":
        return segment_reduce_cells_many_plain(cell, n_cells, slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _reduce(cell, n_cells, [
        (values, validity, kind,
         extreme(values.dtype, kind == "min") if kind in ("min", "max") else None)
        for values, validity, kind in slots])


def segment_reduce_cells(values: Optional[torch.Tensor], cell: torch.Tensor,
                         n_cells: int, kind: str, sentinel=None) -> torch.Tensor:
    """out[c] = the `kind` of values[i] over the rows with cell[i] == c, for
    c in [0, n_cells); rows with a cell outside that range are ignored.

    kind: 'sum' (float64 for float values, int64 for integer values; 0 for
    an empty cell), 'count' (int64 rows per cell; `values` is not read and
    may be None), 'min' / 'max' (in the values' dtype; `sentinel` for an
    empty cell). `cell` is int32; n_cells is at most DENSE_CELL_MAX.
    CPU tensors take segment_reduce_cells_plain; CUDA tensors launch the K3
    kernel once: this is the one-slot call of segment_reduce_cells_many, and
    gives the bits that call gives the slot."""
    _check(values, cell, n_cells, kind, sentinel)
    dev = cell.device
    if dev.type == "cpu":
        return segment_reduce_cells_plain(values, cell, n_cells, kind, sentinel)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if kind == "count":
        values = None
    counts, ((result, _),) = _reduce(cell, n_cells, [(values, None, kind, sentinel)])
    return counts if kind == "count" else result


segment_reduce_cells.launches = 0

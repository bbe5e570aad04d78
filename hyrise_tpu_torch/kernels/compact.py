"""Stream compaction (K9): the plain torch version and the wrapper of the
hand-written CUDA kernel in csrc/compact.cu.

Port of hyrise_tpu/kernels/tpu_prims.py compact_indices / positions_of_true:
the ordered int64 positions of the True entries of a bool mask. Every filter,
every masked-layout compaction and the group boundaries of the general
group-by go through it.

`compact_indices` takes `compact_indices_plain` only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; `launches` counts the
calls that launched and `rows_seen` the mask rows they were given. A call is
one buffer from torch's allocator (the positions at their worst-case length
n, and the kernel's scratch behind them) and one C call that clears the
scratch, launches the one kernel and returns the number of True rows, which
the kernel's last tile writes into pinned host memory: the host learns the
length after all the counting, without a stream synchronisation.

`compact_indices_cap` is the capacity form (plan/compiler.py), the port of
tpu_prims.compact_indices(mask, cap): positions padded with 0 to `cap`
entries and the count as a 0-dim int64 tensor, nothing read on the host, so
that a CUDA graph can capture it; plain version `compact_indices_cap_plain`.
Its C call enqueues a memset of the scratch and one kernel, which writes
every entry of the output once (no memset of the output), and the wrapper
returns views of its one buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from hyrise_tpu_torch.kernels import build

# A result shorter than n / _COPY_BELOW, out of a buffer of at least
# _COPY_MIN_ROWS entries, is copied out of the buffer, so that a selective
# filter's positions (which a table's lazy columns keep alive) do not hold
# n x 8 bytes; any other result is a view of the buffer, which then holds at
# most _COPY_BELOW times what it needs, or under a megabyte. The copy is a
# launch that the host can only enqueue once it knows the count; chip_smoke.py
# ("K9 view or copy") times both forms.
_COPY_BELOW = 4
_COPY_MIN_ROWS = 1 << 17


def compact_indices_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of compact_indices."""
    build.check_tensor(mask, torch.bool, mask.device, "mask")
    return torch.nonzero(mask).squeeze(1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("compact")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.compact_select.argtypes = [ptr, i64, i64, ptr, ptr, ptr]
    lib.compact_select.restype = i64
    lib.compact_tile_rows.argtypes = []
    lib.compact_tile_rows.restype = i32
    lib.compact_scratch_words.argtypes = [i64]
    lib.compact_scratch_words.restype = i64
    lib.compact_cap_tile_rows.argtypes = []
    lib.compact_cap_tile_rows.restype = i32
    lib.compact_select_cap.argtypes = [ptr, i64, i64, ptr, ptr, i64, ptr, ptr]
    lib.compact_select_cap.restype = i32
    return lib


@functools.cache
def _tile_rows() -> int:
    return _library().compact_tile_rows()


def select_into_buffer(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Launch the K9 kernel over a non-empty CUDA mask: (buffer, count). The
    first `count` entries of the int64 buffer are the positions; it is longer
    than len(mask)."""
    dev = mask.device
    n = mask.shape[0]
    lib = _library()
    tiles = -(-n // _tile_rows())
    # positions [0, n), then the kernel's scratch
    buffer = torch.empty(n + lib.compact_scratch_words(tiles), dtype=torch.int64,
                         device=dev)
    with torch.cuda.device(dev):
        count = lib.compact_select(mask.view(torch.uint8).data_ptr(), n, tiles,
                                   buffer.data_ptr() + 8 * n, buffer.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(max(-count, 0), "compact_select")
    build.count_launch(compact_indices, rows_seen=n)
    return buffer, count


def compact_indices(mask: torch.Tensor) -> torch.Tensor:
    """int64 positions of the True entries of a 1-D contiguous bool mask, in
    ascending order. CPU tensors take compact_indices_plain; CUDA tensors
    launch the K9 kernel (one pass over the mask)."""
    dev = mask.device
    if dev.type == "cpu":
        return compact_indices_plain(mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build.check_tensor(mask, torch.bool, dev, "mask")
    n = mask.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    buffer, count = select_into_buffer(mask)
    out = buffer[:count]
    return out.clone() if n >= _COPY_MIN_ROWS and count * _COPY_BELOW < n else out


compact_indices.launches = 0
compact_indices.rows_seen = 0


# -- the capacity form -----------------------------------------------------------


def compact_indices_cap_plain(mask: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of compact_indices_cap: torch.nonzero, cut or
    padded with 0 to cap entries."""
    build.check_tensor(mask, torch.bool, mask.device, "mask")
    if cap < 1:
        raise ValueError(f"capacity {cap} < 1")
    found = torch.nonzero(mask).squeeze(1)
    out = torch.zeros(cap, dtype=torch.int64, device=mask.device)
    kept = found[:cap]
    out[:kept.shape[0]] = kept
    return out, torch.tensor(found.shape[0], dtype=torch.int64, device=mask.device)


def compact_indices_cap(mask: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, count): the int64 positions of the True entries of a 1-D
    contiguous bool mask in ascending order, the first min(count, cap) of
    them, then 0 up to cap entries; and the number of True entries, which
    may exceed cap, as a 0-dim int64 tensor. CPU tensors take
    compact_indices_cap_plain; CUDA tensors launch the K9 kernel's capacity
    form (a memset of the scratch and one kernel, no host wait) or raise."""
    dev = mask.device
    if dev.type == "cpu":
        return compact_indices_cap_plain(mask, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build.check_tensor(mask, torch.bool, dev, "mask")
    if cap < 1:
        raise ValueError(f"capacity {cap} < 1")
    n = mask.shape[0]
    if n == 0:
        return (torch.zeros(cap, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    lib = _library()
    tiles = -(-n // lib.compact_cap_tile_rows())
    # positions [0, cap) (16-byte aligned), the count, then the kernel's scratch
    buffer = torch.empty(cap + 1 + lib.compact_scratch_words(tiles), dtype=torch.int64,
                         device=dev)
    with torch.cuda.device(dev):
        err = lib.compact_select_cap(mask.view(torch.uint8).data_ptr(), n, tiles,
                                     buffer.data_ptr() + 8 * (cap + 1), buffer.data_ptr(),
                                     cap, buffer.data_ptr() + 8 * cap,
                                     torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "compact_select_cap")
    build.count_launch(compact_indices_cap, rows_seen=n)
    return buffer[:cap], buffer[cap]


compact_indices_cap.launches = 0
compact_indices_cap.rows_seen = 0

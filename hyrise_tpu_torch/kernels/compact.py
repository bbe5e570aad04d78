"""Stream compaction (K9): the plain torch version and the wrapper of the
hand-written CUDA kernels in csrc/compact.cu.

Port of hyrise_tpu/kernels/tpu_prims.py compact_indices / positions_of_true:
the ordered int64 positions of the True entries of a bool mask. Every filter,
every masked-layout compaction and the group boundaries of the general
group-by go through it.

`compact_indices` takes `compact_indices_plain` only for tensors on the CPU.
For CUDA tensors it launches the kernels or raises; `launches` counts the
calls that launched. The number of True rows is read on the host once (one
sync) to size the output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyrise_tpu_torch.kernels import build


def compact_indices_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of compact_indices."""
    build.check_tensor(mask, torch.bool, mask.device, "mask")
    return torch.nonzero(mask).squeeze(1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("compact")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.compact_count.argtypes = [ptr, i64, i64, ptr, ptr, ptr]
    lib.compact_count.restype = i32
    lib.compact_write.argtypes = [ptr, i64, i64, ptr, ptr, ptr]
    lib.compact_write.restype = i32
    lib.compact_tile_rows.argtypes = []
    lib.compact_tile_rows.restype = i32
    return lib


def compact_indices(mask: torch.Tensor) -> torch.Tensor:
    """int64 positions of the True entries of a 1-D contiguous bool mask, in
    ascending order. CPU tensors take compact_indices_plain; CUDA tensors
    launch the K9 kernels (count per tile and scan, then write)."""
    dev = mask.device
    if dev.type == "cpu":
        return compact_indices_plain(mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build.check_tensor(mask, torch.bool, dev, "mask")
    n = mask.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    lib = _library()
    tiles = -(-n // lib.compact_tile_rows())
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    mask_ptr = mask.view(torch.uint8).data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.compact_count(mask_ptr, n, tiles, tile_counts.data_ptr(),
                                offsets.data_ptr(), stream)
        build.check_launch(err, "compact_count")
        compact_indices.launches += 1
        out = torch.empty(int(offsets[tiles]), dtype=torch.int64, device=dev)
        if out.shape[0]:
            err = lib.compact_write(mask_ptr, n, tiles, offsets.data_ptr(),
                                    out.data_ptr(), stream)
            build.check_launch(err, "compact_write")
    return out


compact_indices.launches = 0

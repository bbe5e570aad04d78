"""TPC-H Q6 as one fused scan: the plain torch versions and the wrappers of
the hand-written CUDA kernels in csrc/q6_scan.cu.

Port of hyrise_tpu/kernels/q6.py and hyrise_tpu/kernels/pallas_scan.py.
Dates are dictionary codes, so the date range is an integer compare; the
functions take raw column tensors, free of engine types.

- `q6_scan` (K1) replaces the Pallas kernel `_q6_scan_tile_kernel_v2`
  (q6_pallas and q6_pallas_chain); its plain version is `q6_compute`.
- `q6_encoded` (K2) replaces the XLA body of `q6_encoded_chain` over the
  encoded-at-rest columns, exact in int64; its plain version is
  `q6_encoded_reference`.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; `launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hyrise_tpu_torch.kernels import build

# K1: rows one thread covers per grid-stride step, and resident 256-thread
# blocks per SM at full occupancy (2048 threads); K2's come from its source
_F32_ROWS_PER_STEP = 4
_BLOCKS_PER_SM = 8


def _scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def q6_compute(ship: torch.Tensor,    # int32 dictionary codes
               disc: torch.Tensor,    # float32
               qty: torch.Tensor,     # float32
               price: torch.Tensor,   # float32
               live: torch.Tensor,    # bool
               date_lo: int, date_hi: int) -> torch.Tensor:
    """Plain torch Q6 revenue over dense columns: float32 products, summed
    in float32 within 512-row blocks and in float64 across blocks, as
    hyrise_tpu/kernels/q6.py q6_compute does. Returns a float64 scalar."""
    dev = ship.device
    f32 = torch.float32
    mask = (live
            & (ship >= _scalar(date_lo, torch.int32, dev))
            & (ship < _scalar(date_hi, torch.int32, dev))
            & (disc >= _scalar(0.05, f32, dev))
            & (disc <= _scalar(0.07001, f32, dev))
            & (qty < _scalar(24.0, f32, dev)))
    masked = torch.where(mask, price * disc, _scalar(0.0, f32, dev))
    block = 512
    pad = (-masked.shape[0]) % block
    if pad:
        masked = torch.nn.functional.pad(masked, (0, pad))
    partials = masked.view(-1, block).sum(dim=1)
    return partials.to(torch.float64).sum()


def q6_encoded_reference(ship: torch.Tensor,         # int16 dictionary codes
                         disc_cents: torch.Tensor,   # int8, discount * 100
                         qty: torch.Tensor,          # int8, integral quantity
                         price_cents: torch.Tensor,  # int32, price * 100
                         date_lo: int, date_hi: int) -> torch.Tensor:
    """Plain torch Q6 over the encoded columns: int32 product per row, exact
    int64 sum in cents x cents (scale by 1e-4 for the revenue). Returns an
    int64 scalar."""
    dev = ship.device
    i8 = torch.int8
    mask = ((ship >= _scalar(date_lo, torch.int16, dev))
            & (ship < _scalar(date_hi, torch.int16, dev))
            & (disc_cents >= _scalar(5, i8, dev))
            & (disc_cents <= _scalar(7, i8, dev))
            & (qty < _scalar(24, i8, dev)))
    prod = price_cents * disc_cents.to(torch.int32)
    masked = torch.where(mask, prod, _scalar(0, torch.int32, dev))
    return masked.to(torch.int64).sum()


# -- kernel wrappers ----------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("q6_scan")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.q6_scan_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr,
                                i32, ptr]
    lib.q6_scan_f32.restype = i32
    lib.q6_encoded_i64.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr,
                                   ptr, i32, ptr]
    lib.q6_encoded_i64.restype = i32
    for shape in (lib.q6_threads_per_block, lib.q6_encoded_rows_per_step,
                  lib.q6_encoded_blocks_per_sm):
        shape.argtypes = []
        shape.restype = i32
    return lib


def _check_columns(columns, dtypes) -> torch.device:
    """All columns 1-D, contiguous, equally long, on one device, of the
    given dtypes; returns the device."""
    n = columns[0].shape[0]
    dev = columns[0].device
    for t, dt in zip(columns, dtypes):
        if t.dtype != dt:
            raise TypeError(f"expected {dt}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"expected 1-D columns of {n} rows, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"columns on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("columns must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _blocks(n: int, rows_per_step: int, blocks_per_sm: int, lib: ctypes.CDLL, dev) -> int:
    return build.grid_blocks(n, lib.q6_threads_per_block() * rows_per_step,
                             blocks_per_sm, dev)


def _check_bounds(date_lo: int, date_hi: int, bits: int) -> None:
    for bound in (date_lo, date_hi):
        if not -2**(bits - 1) <= bound < 2**(bits - 1):
            raise ValueError(f"date code {bound} does not fit int{bits} codes")


def q6_scan(ship, disc, qty, price, live, date_lo: int, date_hi: int) -> torch.Tensor:
    """Q6 revenue over dense columns (see q6_compute) as a float64 scalar.
    CPU tensors take q6_compute; CUDA tensors launch the K1 kernel."""
    dev = _check_columns((ship, disc, qty, price, live),
                         (torch.int32, torch.float32, torch.float32,
                          torch.float32, torch.bool))
    _check_bounds(date_lo, date_hi, 32)
    if dev.type == "cpu":
        return q6_compute(ship, disc, qty, price, live, date_lo, date_hi)
    lib = _library()
    n = ship.shape[0]
    blocks = _blocks(n, _F32_ROWS_PER_STEP, _BLOCKS_PER_SM, lib, dev)
    partials = torch.empty(blocks, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.q6_scan_f32(ship.data_ptr(), disc.data_ptr(), qty.data_ptr(),
                              price.data_ptr(), live.view(torch.uint8).data_ptr(),
                              n, date_lo, date_hi, partials.data_ptr(), blocks,
                              stream)
    build.check_launch(err, "q6_scan_f32")
    build.count_launch(q6_scan)
    return partials.to(torch.float64).sum()


q6_scan.launches = 0


def q6_encoded(ship, disc_cents, qty, price_cents, date_lo: int,
               date_hi: int) -> torch.Tensor:
    """Exact Q6 total over encoded columns (see q6_encoded_reference) as an
    int64 scalar. CPU tensors take q6_encoded_reference; CUDA tensors launch
    the K2 kernel, one kernel a call (its last block writes the total)."""
    dev = _check_columns((ship, disc_cents, qty, price_cents),
                         (torch.int16, torch.int8, torch.int8, torch.int32))
    _check_bounds(date_lo, date_hi, 16)
    if dev.type == "cpu":
        return q6_encoded_reference(ship, disc_cents, qty, price_cents,
                                    date_lo, date_hi)
    lib = _library()
    n = ship.shape[0]
    blocks = _blocks(n, lib.q6_encoded_rows_per_step(), lib.q6_encoded_blocks_per_sm(), lib,
                     dev)
    partials = torch.empty(blocks, dtype=torch.int64, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.q6_encoded_i64(ship.data_ptr(), disc_cents.data_ptr(),
                                 qty.data_ptr(), price_cents.data_ptr(), n,
                                 date_lo, date_hi, partials.data_ptr(),
                                 build.ticket(dev, "q6_encoded").data_ptr(),
                                 out.data_ptr(), blocks, stream)
    build.check_launch(err, "q6_encoded_i64")
    build.count_launch(q6_encoded)
    return out


q6_encoded.launches = 0

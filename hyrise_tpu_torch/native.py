"""ctypes bindings for the native host-runtime library.

Port of hyrise_tpu/native.py. The library is the shared, unedited
`native/hyrise_native.cpp`, compiled here with g++ at first use into
`kernels/_build/` under a name hashed from the source and the flags (as
kernels/build.py does for nvcc), so an edited source is rebuilt and
concurrent builds never share a partial file. A failed build raises: there
is no numpy fallback behind the library. The numpy versions that the JAX
file keeps as fallbacks are the plain versions here (`*_plain`); the tests
hold the library against them.

Used by parallel/partition.py (routing rows to shards) and
parallel/skew.py (hot-key routing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "hyrise_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "kernels" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
HASH_MULT = 0x9E3779B97F4A7C15

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhyrise_native-{digest.hexdigest()[:16]}.so"


def _library() -> ctypes.CDLL:
    """The library, built with g++ on first use (once per process; another
    process may build at once: each writes its own partial file and renames
    it into place). Raises with g++'s output if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            partial = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.partial")
            done = subprocess.run(["g++", *CXX_FLAGS, "-o", str(partial), str(SOURCE)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{done.stderr}")
            os.replace(partial, path)
        lib = ctypes.CDLL(str(path))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.hash_partition_i64.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.hash_partition_i64.restype = None
        lib.radix_histogram.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p]
        lib.radix_histogram.restype = None
        lib.radix_scatter.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
        lib.radix_scatter.restype = None
        lib.parse_text_column.restype = ctypes.c_int64
        lib.parse_text_column.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int32, ctypes.c_char,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def hash_partition(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """int32 shard target of each int key; equals exchange.partition_hash."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), dtype=np.int32)
    _library().hash_partition_i64(_ptr(keys, ctypes.c_int64), len(keys), n_shards,
                                  _ptr(out, ctypes.c_int32))
    return out


def hash_partition_plain(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """hash_partition in numpy: Fibonacci hashing modulo 2^64, then mod."""
    h = np.asarray(keys, dtype=np.int64).astype(np.uint64) * np.uint64(HASH_MULT)
    return ((h >> np.uint64(1)) % np.uint64(n_shards)).astype(np.int32)


def _check_targets(targets: np.ndarray, n_shards: int) -> np.ndarray:
    targets = np.ascontiguousarray(targets, dtype=np.int32)
    if len(targets) and (targets.min() < 0 or targets.max() >= n_shards):
        raise ValueError(f"shard targets outside [0, {n_shards})")
    return targets


def radix_route(targets: np.ndarray, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows per shard, the row order grouped by shard, stable within one)."""
    targets = _check_targets(targets, n_shards)
    lib = _library()
    hist = np.empty(n_shards, dtype=np.int64)
    lib.radix_histogram(_ptr(targets, ctypes.c_int32), len(targets), n_shards,
                        _ptr(hist, ctypes.c_int64))
    offsets = np.ascontiguousarray(np.concatenate([[0], np.cumsum(hist)[:-1]]), dtype=np.int64)
    order = np.empty(len(targets), dtype=np.int64)
    lib.radix_scatter(_ptr(targets, ctypes.c_int32), len(targets), n_shards,
                      _ptr(offsets, ctypes.c_int64), _ptr(order, ctypes.c_int64))
    return hist, order


def radix_route_plain(targets: np.ndarray, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """radix_route in numpy."""
    targets = _check_targets(targets, n_shards)
    hist = np.bincount(targets, minlength=n_shards).astype(np.int64)
    return hist, np.argsort(targets, kind="stable").astype(np.int64)


def parse_text_column(path: str, sep: str, col_idx: int, kind: str, skip_rows: int,
                      max_rows: int) -> np.ndarray:
    """Column `col_idx` of a `sep`-separated text file as int64 (kind "l")
    or float64 ("d"), from row `skip_rows` on, skipping empty lines. Raises
    if the file cannot be opened or holds more than `max_rows` rows."""
    if kind not in ("l", "d"):
        raise ValueError(f"kind must be 'l' or 'd', got {kind!r}")
    out = np.empty(max_rows, dtype=np.int64 if kind == "l" else np.float64)
    n = _library().parse_text_column(str(path).encode(), sep.encode(), col_idx, kind.encode(),
                                     skip_rows, out.ctypes.data_as(ctypes.c_void_p), max_rows)
    if n == -1:
        raise OSError(f"cannot open {path}")
    if n == -2:
        raise ValueError(f"{path} holds more than {max_rows} rows")
    return out[:n]


def parse_text_column_plain(path: str, sep: str, col_idx: int, kind: str, skip_rows: int,
                            max_rows: int) -> np.ndarray:
    """parse_text_column in Python: the same rows, and the same conversions
    (strtoll and strtod read a field's leading number, else give 0)."""
    import re
    number = re.compile(r"\s*[-+]?\d+" if kind == "l" else
                        r"\s*[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?|inf|nan)", re.I)
    convert = int if kind == "l" else float
    with open(path, "rb") as f:
        lines = f.read().decode().split("\n")
    values = []
    for row, line in enumerate(lines):
        fields = line.split(sep)
        if row < skip_rows or line == "" or col_idx >= len(fields):
            continue
        m = number.match(fields[col_idx])
        values.append(convert(m.group(0)) if m else 0)
    if len(values) > max_rows:
        raise ValueError(f"{path} holds more than {max_rows} rows")
    return np.array(values, dtype=np.int64 if kind == "l" else np.float64)

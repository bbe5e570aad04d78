"""Builds and loads the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. The build runs on
first use, inside the process that launches a kernel, into `_build/` next
to this file; the library's name carries a hash of the source, of every
file under `csrc/` that it includes and of the flags, so an edited source or
header is rebuilt and concurrent builds never share a partial file.
`build_all` compiles all sources at once, one nvcc process each. Threads of
one process build and load a source once: a lock per source is held around
the compile and the load (server sessions whose first queries reach the
same unbuilt kernel wait for one build).
Nothing here runs at import: a machine without nvcc can import every
module and use the plain torch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("q6_scan", "group_reduce", "join_probe", "fused_reduce",
           "segment_reduce", "hash_lookup", "compact")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(candidate)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _source_files(name: str, csrc_dir: Path) -> list:
    """csrc_dir/<name>.cu and, after it, every file of csrc_dir that it
    includes by #include "...", directly or through another such file."""
    files = [csrc_dir / f"{name}.cu"]
    for path in files:
        for included in _INCLUDE.findall(path.read_bytes()):
            header = csrc_dir / included.decode()
            if header.exists() and header not in files:
                files.append(header)
    return files


def _library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(name, csrc_dir):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


_source_locks: dict = {}
_source_locks_guard = threading.Lock()
_loaded: dict = {}


def _source_lock(name: str) -> threading.RLock:
    """The lock of one source: held around its compile and its load, so
    that threads of this process build it once."""
    with _source_locks_guard:
        return _source_locks.setdefault(name, threading.RLock())


def _compile(name: str) -> None:
    """Compile csrc/<name>.cu unless its library is there; raises with nvcc's
    output if it fails. The .log beside the library keeps nvcc's output and,
    as its first line, the seconds nvcc took. Another process may build the
    same source at once: each writes a partial file of its own (process and
    thread in its name) and renames it into place."""
    with _source_lock(name):
        lib = _library_path(name)
        if lib.exists():
            return
        BUILD_DIR.mkdir(exist_ok=True)
        partial = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.partial")
        t0 = time.perf_counter()
        done = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{done.stderr}")
        lib.with_suffix(".log").write_text(
            f"nvcc seconds: {time.perf_counter() - t0:.2f}\n{done.stdout}{done.stderr}")
        os.replace(partial, lib)


def build_all() -> None:
    """Compile every source of SOURCES whose library is missing, one nvcc
    process each, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(_compile, SOURCES))


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it if needed; one
    build and one load per source and process, whichever threads ask."""
    with _source_lock(name):
        if name not in _loaded:
            _compile(name)
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]


_counts_lock = threading.Lock()
_counted: dict = {}  # wrapper name -> wrapper, each that has launched


def count_launch(wrapper, **counts: int) -> None:
    """One more launch of `wrapper` (its `launches` attribute), and each of
    `counts` added to the attribute of that name, under one lock: wrappers
    launch from several threads (server sessions, the operator scheduler),
    and `x.launches += 1` is a read and a write that threads can interleave."""
    with _counts_lock:
        _counted[wrapper.__name__] = wrapper
        wrapper.launches += 1
        for name, n in counts.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)


def launch_counts() -> dict:
    """`launches` of every wrapper that has launched, by its name."""
    with _counts_lock:
        return {name: w.launches for name, w in _counted.items()}


def build_log(name: str) -> str:
    """nvcc's seconds and output (ptxas register and spill counts) from the
    build that produced the current library, or "" if it was not built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_launch(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def check_tensor(t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                 what: str) -> None:
    """A kernel argument must be 1-D, contiguous, of `dtype`, on `device`."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


@functools.cache
def sm_count(device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def ticket(device, owner: str) -> torch.Tensor:
    """A zeroed int32 word on `device` for the kernels of `owner`: a launch
    takes a ticket from it per block and its last block puts it back to 0,
    so it is allocated and cleared once. Launches that share it must run one
    after another (one stream), as every caller of the port's kernels does."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def grid_blocks(n: int, rows_per_block: int, blocks_per_sm: int, device) -> int:
    """Blocks for a grid-stride kernel over n rows: enough to cover the
    rows once, at most blocks_per_sm resident blocks on every SM."""
    return max(1, min(-(-n // rows_per_block), sm_count(device) * blocks_per_sm))

"""Builds and loads the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. The build runs on
first use, inside the process that launches a kernel, into `_build/` next
to this file; the library's name carries a hash of the source and flags, so
an edited source is rebuilt and concurrent builds never share a partial
file. `build_all` compiles all sources at once, one nvcc process each.
Nothing here runs at import: a machine without nvcc can import every
module and use the plain torch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
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


def _library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str) -> None:
    """Compile csrc/<name>.cu unless its library is there; raises with nvcc's
    output if it fails. The .log beside the library keeps nvcc's output and,
    as its first line, the seconds nvcc took."""
    lib = _library_path(name)
    if lib.exists():
        return
    BUILD_DIR.mkdir(exist_ok=True)
    partial = lib.with_name(f"{lib.name}.{os.getpid()}.partial")
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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it if needed."""
    _compile(name)
    return ctypes.CDLL(str(_library_path(name)))


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


def grid_blocks(n: int, rows_per_block: int, blocks_per_sm: int, device) -> int:
    """Blocks for a grid-stride kernel over n rows: enough to cover the
    rows once, at most blocks_per_sm resident blocks on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // rows_per_block), sms * blocks_per_sm))

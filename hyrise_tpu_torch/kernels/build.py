"""Builds and loads the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. The build runs on
first use, inside the process that launches a kernel, into `_build/` next
to this file; the library's name carries a hash of the source and flags, so
an edited source is rebuilt and concurrent builds never share a partial
file. Nothing here runs at import: a machine without nvcc can import every
module and use the plain torch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, compiling it if needed."""
    lib = _library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        partial = lib.with_name(f"{lib.name}.{os.getpid()}.partial")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(partial, lib)
    return ctypes.CDLL(str(lib))


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill counts) from the build that
    produced the current library, or "" if it was not built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""

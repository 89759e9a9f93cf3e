"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. Libraries are
named by a hash of their source, built at first use into `_build/` beside
this file (listed in `.gitignore`), and written under a temporary name and
renamed, so concurrent builders never load a half-written file. Nothing is
built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = {"attention_fwd": CSRC / "attention_fwd.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> dict:
    """Compile source `name` with `nvcc` unless it is built already.
    Returns the wall seconds of the build (0.0 when it was built) and the
    compiler's `-Xptxas -v` report (registers, shared memory, spills)."""
    lib = library_path(name)
    if lib.exists():
        return {"seconds": 0.0, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib

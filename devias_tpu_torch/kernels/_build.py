"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. Libraries are
named by a hash of their source, of every header under `csrc/` that it
includes (directly or through another header) and of the flags, built at
first use into `_build/` beside this file (listed in `.gitignore`), and
written under a temporary name and renamed, so concurrent builders never
load a half-written file. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = {
    "attention_fwd": CSRC / "attention_fwd.cu",
    "attention_bwd": CSRC / "attention_bwd.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

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


def local_includes(path: Path) -> List[Path]:
    """`path` and every file under `csrc/` it includes with `#include "..."`,
    followed through headers, each once, in the order first reached."""
    seen: List[Path] = []
    todo = [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for name in _INCLUDE.findall(p.read_text()):
            dep = (p.parent / name).resolve()
            if dep.is_file() and CSRC in dep.parents:
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in local_includes(SOURCES[name]):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, dict]:
    """Compile the named sources (all by default) that are not built yet,
    one `nvcc` each, all started together. Returns, per source, the wall
    seconds of its build (0.0 when it was built) and the compiler's
    `-Xptxas -v` report (registers, shared memory, spills)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, running = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib

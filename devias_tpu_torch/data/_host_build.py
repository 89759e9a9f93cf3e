"""Build the port's host C++ cores (`csrc/*.cpp`) into shared libraries.

Each library is named by a hash of its source and its compiler line, built
with the host C++ compiler (`$CXX`, else `g++`) at first use into `_build/`
beside this file (listed in `.gitignore`), and written under a temporary
name and renamed, so concurrent builders (test workers, loader processes)
never load a half-written file. Nothing is built when a module is
imported. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no host C++ compiler {cxx!r} on PATH; the port's host cores need one")
    return found


def build_library(name: str, flags: Sequence[str], libs: Sequence[str] = ()) -> Path:
    """The shared library of `csrc/{name}.cpp` built with `flags` and
    linked with `libs`, compiled first if it is not built yet."""
    source = CSRC / f"{name}.cpp"
    cmd = [*flags, "-shared", "-o", "{out}", str(source), *libs]
    digest = hashlib.sha256(" ".join(cmd).encode() + b"\0" + source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *(str(tmp) if c == "{out}" else c for c in cmd)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib

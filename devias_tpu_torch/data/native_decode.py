"""ctypes binding for the port's FFmpeg decode core (`csrc/decode_core.cpp`,
a copy of the JAX package's `native/decode_core.cpp`), the same API as
`devias_tpu/data/native_decode.py`.

Whether the core is used is decided once per process, at the first
`available()`: it is where `pkg-config --cflags --libs libavformat
libavcodec libavutil libswscale` resolves (the flags of the JAX package's
`native/Makefile`). Then `video_reader.open_video` prefers it, the core is built with g++ at first
use, and a failed build raises; elsewhere the readers stay on cv2.
Nothing is installed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from devias_tpu_torch.data._host_build import build_library

_FFMPEG_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _pkg_config() -> Optional[Tuple[list, list]]:
    """(cflags, libs) of FFmpeg from pkg-config, or None where it does not
    resolve."""
    try:
        flags = [subprocess.run(["pkg-config", what, *_FFMPEG_PACKAGES], capture_output=True, text=True,
                                timeout=30, check=True).stdout.split() for what in ("--cflags", "--libs")]
    except (OSError, subprocess.SubprocessError):
        return None
    return flags[0], flags[1]


_UNSET = object()
_FFMPEG = _UNSET  # (cflags, libs), or None where the core is off
_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


def ffmpeg_flags() -> Optional[Tuple[list, list]]:
    """FFmpeg's (cflags, libs) where the core is on, else None; looked up
    once per process."""
    global _FFMPEG
    if _FFMPEG is _UNSET:
        _FFMPEG = _pkg_config()
    return _FFMPEG


def available() -> bool:
    """Whether the readers take this core."""
    return ffmpeg_flags() is not None


def _load() -> ctypes.CDLL:
    """The loaded core, built first if needed. Raises where `available()`
    is false or the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if ffmpeg_flags() is None:
        raise RuntimeError("the decode core is off: pkg-config does not resolve FFmpeg")
    with _BUILD_LOCK:
        if _LIB is None:
            cflags, libs = ffmpeg_flags()
            lib = ctypes.CDLL(str(build_library("decode_core", ["-O3", "-fPIC", "-std=c++17", "-Wall", *cflags],
                                                libs)))
            lib.devias_open.argtypes = [ctypes.c_char_p]
            lib.devias_open.restype = ctypes.c_void_p
            lib.devias_open_cached.argtypes = [ctypes.c_char_p, _i64p, _i32p, ctypes.c_int64]
            lib.devias_open_cached.restype = ctypes.c_void_p
            lib.devias_export_index.argtypes = [ctypes.c_void_p, _i64p, _i32p]
            lib.devias_export_index.restype = None
            lib.devias_num_frames.argtypes = [ctypes.c_void_p]
            lib.devias_num_frames.restype = ctypes.c_int64
            lib.devias_frame_size.argtypes = [ctypes.c_void_p, _i32p, _i32p]
            lib.devias_frame_size.restype = ctypes.c_int32
            lib.devias_get_batch.argtypes = [ctypes.c_void_p, _i64p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
            lib.devias_get_batch.restype = ctypes.c_int32
            lib.devias_close.argtypes = [ctypes.c_void_p]
            lib.devias_close.restype = None
            _LIB = lib
    return _LIB


# The frame-index cache: training reopens every file each epoch, and the
# scanning open demuxes the whole file. The (pts, keyframe) index of an
# unchanged file does not change, so it is cached under (path, mtime_ns,
# size) and injected on reopen (devias_open_cached). A bounded LRU of about
# 12 bytes a frame: 8192 entries of 300-frame clips take about 30 MB.
# DEVIAS_NO_DECODE_INDEX_CACHE turns it off.
_INDEX_CACHE: "dict[tuple, tuple[np.ndarray, np.ndarray]]" = {}
_INDEX_LOCK = threading.Lock()
_INDEX_CACHE_MAX = 8192


def _cache_key(path: str):
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def open(path: str):
    lib = _load()
    key = None
    if not os.environ.get("DEVIAS_NO_DECODE_INDEX_CACHE"):
        try:
            key = _cache_key(path)
        except OSError:
            key = None
        if key is not None:
            with _INDEX_LOCK:
                hit = _INDEX_CACHE.get(key)
            if hit is not None:
                pts, kf = hit
                h = lib.devias_open_cached(path.encode(), pts.ctypes.data_as(_i64p), kf.ctypes.data_as(_i32p),
                                           len(pts))
                if h:
                    return h
                # the cached open failed (the file vanished or changed): the
                # scanning open below refreshes the entry
    h = lib.devias_open(path.encode())
    if not h:
        raise RuntimeError(f"native decode open failed: {path}")
    if key is not None:
        n = int(lib.devias_num_frames(h))
        pts, kf = np.empty(n, np.int64), np.empty(n, np.int32)
        lib.devias_export_index(h, pts.ctypes.data_as(_i64p), kf.ctypes.data_as(_i32p))
        with _INDEX_LOCK:
            if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
                _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
            _INDEX_CACHE[key] = (pts, kf)
    return h


def num_frames(handle) -> int:
    return int(_load().devias_num_frames(handle))


def frame_size(handle):
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if _load().devias_frame_size(handle, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise RuntimeError("native frame_size failed")
    return int(h.value), int(w.value)


def get_batch(handle, indices: np.ndarray) -> np.ndarray:
    h, w = frame_size(handle)
    idx = np.ascontiguousarray(indices, np.int64)
    out = np.empty((len(idx), h, w, 3), np.uint8)
    rc = _load().devias_get_batch(handle, idx.ctypes.data_as(_i64p), len(idx),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"native get_batch failed rc={rc}")
    return out


def close(handle) -> None:
    _load().devias_close(handle)

"""ctypes binding for the port's host RandAugment core
(`csrc/augment_core.cpp`, a copy of the JAX package's
`native/augment_core.cpp`), the same API as
`devias_tpu/data/native_augment.py`.

The core is built with g++ at first use, with the flags of the JAX
package's `native/Makefile` (`AUGMENT_FLAGS`; `-ffp-contract=off` keeps
PIL's separate float32 multiply and add in the blends, which the exact
Sharpness parity needs), and a failed build raises. `data/fast_augment.py`
sends AutoContrast, Equalize, Color, Contrast, Sharpness and the
shear/translate warps to it, as the JAX package does with its library.
Setting `DEVIAS_NO_NATIVE_AUGMENT` (read at first use) switches it off,
and those ops take the numpy/cv2 path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from devias_tpu_torch.data._host_build import build_library

AUGMENT_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-mavx2", "-mfma", "-funroll-loops", "-ffp-contract=off")

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded core, built first if needed; None when switched off."""
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    if os.environ.get("DEVIAS_NO_NATIVE_AUGMENT"):
        _SEARCHED = True
        return None
    lib = ctypes.CDLL(str(build_library("augment_core", AUGMENT_FLAGS)))
    lib.devias_gray601.argtypes = [_u8p, _u8p, ctypes.c_int64]
    lib.devias_gray_mean.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64, _f64p]
    lib.devias_hist.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64, _u32p]
    lib.devias_lut.argtypes = [_u8p, _u8p, _u8p, ctypes.c_int64, ctypes.c_int64]
    lib.devias_color.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_double]
    lib.devias_sharpness.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
    for f in (lib.devias_warp_x, lib.devias_warp_y):
        f.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                      ctypes.c_uint8, _i32p]
    for name in ("gray601", "gray_mean", "hist", "lut", "color", "sharpness", "warp_x", "warp_y"):
        getattr(lib, f"devias_{name}").restype = None
    _LIB, _SEARCHED = lib, True
    return lib


def available() -> bool:
    return _load() is not None


def has_sharpness() -> bool:
    """Always the case when the core is on: the port builds its own copy,
    which has the Sharpness symbol (the JAX package's committed library
    may predate it)."""
    return available()


def _p(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def _c(clip: np.ndarray) -> np.ndarray:
    if clip.dtype != np.uint8 or clip.ndim != 4 or clip.shape[-1] != 3:
        raise ValueError(f"the augment core takes uint8 clips [T, H, W, 3]; got {clip.dtype} {clip.shape}")
    return np.ascontiguousarray(clip)


def gray601(clip: np.ndarray) -> np.ndarray:
    """[T,H,W,3] uint8 -> [T,H,W] truncating ITU-R 601-2 luma."""
    lib = _load()
    clip = _c(clip)
    out = np.empty(clip.shape[:-1], np.uint8)
    lib.devias_gray601(_p(clip, _u8p), _p(out, _u8p), clip.size // 3)
    return out


def gray_mean_per_frame(clip: np.ndarray) -> np.ndarray:
    lib = _load()
    clip = _c(clip)
    t = clip.shape[0]
    means = np.empty(t, np.float64)
    lib.devias_gray_mean(_p(clip, _u8p), t, clip[0].size // 3, _p(means, _f64p))
    return means


def hist_per_frame(clip: np.ndarray) -> np.ndarray:
    """-> [T, 3, 256] uint32 per-frame per-channel histograms."""
    lib = _load()
    clip = _c(clip)
    t = clip.shape[0]
    hist = np.empty((t, 3, 256), np.uint32)
    lib.devias_hist(_p(clip, _u8p), t, clip[0].size // 3, _p(hist, _u32p))
    return hist


def lut_per_frame(clip: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """luts [T, 3, 256] uint8 applied per frame per channel."""
    lib = _load()
    clip = _c(clip)
    luts = np.ascontiguousarray(luts, np.uint8)
    if luts.shape != (clip.shape[0], 3, 256):
        raise ValueError(f"luts {luts.shape}; want {(clip.shape[0], 3, 256)}")
    out = np.empty_like(clip)
    lib.devias_lut(_p(clip, _u8p), _p(luts, _u8p), _p(out, _u8p), clip.shape[0], clip[0].size // 3)
    return out


def sharpness_blend(clip: np.ndarray, f: float) -> np.ndarray:
    """Fused PIL Sharpness: blend(SMOOTH(clip), clip, f), exact Pillow
    semantics (truncating blend, floor(conv/13 + 0.5) filter, untouched
    1-px border)."""
    lib = _load()
    clip = _c(clip)
    t, h, w, _ = clip.shape
    out = np.empty_like(clip)
    lib.devias_sharpness(_p(clip, _u8p), _p(out, _u8p), t, h, w, float(f))
    return out


def color_blend(clip: np.ndarray, f: float) -> np.ndarray:
    """Fused PIL Color: blend(gray3(clip), clip, f)."""
    lib = _load()
    clip = _c(clip)
    out = np.empty_like(clip)
    lib.devias_color(_p(clip, _u8p), _p(out, _u8p), clip.size // 3, float(f))
    return out


def _warp(fn_name: str, clip: np.ndarray, shear: float, off: float, fill: int, interp_flags) -> np.ndarray:
    lib = _load()
    clip = _c(clip)
    t, h, w, _ = clip.shape
    out = np.empty_like(clip)
    flags = np.ascontiguousarray(np.asarray(interp_flags, np.int32))  # 1 = cubic, 0 = linear, per frame
    if flags.shape != (t,):
        raise ValueError(f"interpolation flags {flags.shape}; want ({t},)")
    getattr(lib, fn_name)(_p(clip, _u8p), _p(out, _u8p), t, h, w, float(shear), float(off), fill, _p(flags, _i32p))
    return out


def warp_x(clip: np.ndarray, shear: float, tx: float, fill: int, interp_flags) -> np.ndarray:
    """Inverse-map src_x = x + shear*y + tx (src_y = y)."""
    return _warp("devias_warp_x", clip, shear, tx, fill, interp_flags)


def warp_y(clip: np.ndarray, shear: float, ty: float, fill: int, interp_flags) -> np.ndarray:
    """Inverse-map src_y = y + shear*x + ty (src_x = x)."""
    return _warp("devias_warp_y", clip, shear, ty, fill, interp_flags)

"""RandAugment ops on whole uint8 clips in numpy and cv2 (port of
`devias_tpu/data/fast_augment.py`, its cv2 path).

Point ops are LUTs or arithmetic across all T frames at once, geometric
ops go through cv2.warpAffine. PIL-semantics notes (the JAX package holds
this path against PIL in `tests/test_fast_augment.py`):
  * Color/Contrast/Brightness/Sharpness are PIL ImageEnhance blends:
    out = other*(1-f) + img*f, rounded and saturated by cv2.addWeighted
  * Contrast blends against the mean of the ITU-R 601-2 grayscale,
    computed per frame; Color blends against the grayscale itself
  * Sharpness uses PIL's SMOOTH kernel ([1,1,1],[1,5,1],[1,1,1])/13 and
    leaves the 1-pixel border untouched
  * Equalize follows PIL's stepped-LUT histogram equalization
  * affine ops use the INVERSE-map convention PIL's Image.transform uses
AutoContrast, Equalize, Color, Contrast, Sharpness and the
shear/translate warps go to the port's C++ core (`data/native_augment.py`,
a copy of the JAX package's `native/augment_core.cpp`) unless
`DEVIAS_NO_NATIVE_AUGMENT` switches it off, at the same points as in
`devias_tpu/data/fast_augment.py`, so the clips are the JAX package's. Its
Sharpness is Pillow's exactly (the cv2 path rounds where PIL truncates) and
its warps take PIL's a=-1.0 cubic and fill rule (cv2 takes a=-0.75 and
fills taps). cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

import random as _random

import numpy as np

from devias_tpu_torch.data import native_augment as NA

_FILL = 128


def _lut(clip: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply one 256-entry LUT to the whole clip via cv2 (SIMD)."""
    import cv2

    T, H, W, C = clip.shape
    flat = clip.reshape(T * H, W, C)
    return cv2.LUT(flat, np.clip(lut, 0, 255).astype(np.uint8)).reshape(clip.shape)


def _gray(clip: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma (PIL convert('L') semantics, truncating)."""
    c = clip.astype(np.uint32)
    return ((c[..., 0] * 299 + c[..., 1] * 587 + c[..., 2] * 114) // 1000).astype(np.uint8)


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    """PIL Image.blend(a, b, f) = a*(1-f) + b*f, rounded, clipped.
    cv2.addWeighted saturates and rounds like PIL (<=1 level difference)."""
    import cv2

    shape = a.shape
    a2 = np.ascontiguousarray(a).reshape(-1, shape[-1])
    b2 = np.ascontiguousarray(b).reshape(-1, shape[-1])
    return cv2.addWeighted(a2, 1.0 - f, b2, f, 0.0).reshape(shape)


def _autocontrast_luts_from_hist(hist: np.ndarray) -> np.ndarray:
    """hist [T,3,256] -> per-frame per-channel autocontrast LUTs [T,3,256]:
    the per-frame branch below vectorized across (frame, channel)."""
    idx = np.arange(256, dtype=np.float64)
    present = hist > 0  # [T,3,256]
    lo = np.argmax(present, axis=-1).astype(np.float64)  # first nonzero
    hi = (255 - np.argmax(present[..., ::-1], axis=-1)).astype(np.float64)
    span = np.where(hi > lo, hi - lo, 1.0)
    luts = np.clip(np.round((idx[None, None] - lo[..., None]) * (255.0 / span[..., None])), 0, 255)
    return np.where((hi > lo)[..., None], luts, idx[None, None]).astype(np.uint8)


def autocontrast(clip: np.ndarray) -> np.ndarray:
    """PIL ImageOps.autocontrast (cutoff 0) per frame and channel."""
    if NA.available():
        return NA.lut_per_frame(clip, _autocontrast_luts_from_hist(NA.hist_per_frame(clip)))
    import cv2

    out = np.empty_like(clip)
    idx = np.arange(256, dtype=np.float64)
    # per-(frame, channel) extrema via cv2.reduce (SIMD; numpy's strided
    # uint8 channel reduction is ~20x slower)
    T = clip.shape[0]
    flat = clip.reshape(T, -1, 3)
    los = np.stack(
        [cv2.reduce(flat[t], 0, cv2.REDUCE_MIN).ravel() for t in range(T)]
    ).astype(np.float64)
    his = np.stack(
        [cv2.reduce(flat[t], 0, cv2.REDUCE_MAX).ravel() for t in range(T)]
    ).astype(np.float64)
    for t in range(T):
        lo, hi = los[t], his[t]
        span = np.where(hi > lo, hi - lo, 1.0)
        luts = np.clip(np.round((idx[:, None] - lo) * (255.0 / span)), 0, 255)
        luts = np.where(hi > lo, luts, idx[:, None]).astype(np.uint8)  # [256, 3]
        out[t] = cv2.LUT(clip[t], np.ascontiguousarray(luts[None]))  # lut[0, i, c]
    return out


def _equalize_luts_from_hist(hist: np.ndarray) -> np.ndarray:
    """hist [T,3,256] -> PIL stepped-equalization LUTs [T,3,256]: the
    per-frame branch below vectorized across (frame, channel)."""
    h = hist.astype(np.int64)
    total = h.sum(-1)  # [T,3]
    nz = h > 0
    n_nz = nz.sum(-1)
    # value of the LAST nonzero bin
    last_idx = 255 - np.argmax(nz[..., ::-1], axis=-1)
    last = np.take_along_axis(h, last_idx[..., None], axis=-1)[..., 0]
    step = (total - last) // 255  # [T,3]
    excl = np.concatenate([np.zeros_like(h[..., :1]), np.cumsum(h, axis=-1)[..., :-1]], axis=-1)
    safe_step = np.maximum(step, 1)[..., None]
    luts = np.clip((safe_step // 2 + excl) // safe_step, 0, 255)
    identity = np.arange(256, dtype=np.int64)[None, None]
    use_id = (n_nz <= 1) | (step == 0)
    return np.where(use_id[..., None], identity, luts).astype(np.uint8)


def equalize(clip: np.ndarray) -> np.ndarray:
    """PIL ImageOps.equalize: stepped LUT per channel per frame,
    lut[i] = (step//2 + excl_cumsum(h)[i]) // step."""
    if NA.available():
        return NA.lut_per_frame(clip, _equalize_luts_from_hist(NA.hist_per_frame(clip)))
    import cv2

    out = np.empty_like(clip)
    identity = np.arange(256, dtype=np.uint8)
    for t in range(clip.shape[0]):
        frame = clip[t]
        luts = np.empty((256, 3), np.uint8)
        for c in range(3):
            h = np.bincount(frame[:, :, c].ravel(), minlength=256)
            nonzero = h[h != 0]
            if len(nonzero) <= 1:
                luts[:, c] = identity
                continue
            step = (int(h.sum()) - int(nonzero[-1])) // 255
            if step == 0:
                luts[:, c] = identity
                continue
            excl = np.concatenate(([0], np.cumsum(h)[:-1]))
            luts[:, c] = np.clip((step // 2 + excl) // step, 0, 255).astype(np.uint8)
        out[t] = cv2.LUT(frame, np.ascontiguousarray(luts[None]))
    return out


def invert(clip: np.ndarray) -> np.ndarray:
    return 255 - clip


def posterize(clip: np.ndarray, bits: int) -> np.ndarray:
    bits = max(int(bits), 1)
    mask = ~np.uint8(2 ** (8 - bits) - 1)
    return clip & mask


def solarize(clip: np.ndarray, thresh: float) -> np.ndarray:
    lut = np.arange(256)
    lut = np.where(lut < int(thresh), lut, 255 - lut)
    return _lut(clip, lut)


def solarize_add(clip: np.ndarray, add: float, thresh: int = 128) -> np.ndarray:
    lut = np.arange(256)
    lut = np.where(lut < thresh, np.minimum(255, lut + int(add)), lut)
    return _lut(clip, lut)


def color(clip: np.ndarray, f: float) -> np.ndarray:
    if NA.available():
        return NA.color_blend(clip, f)
    g = _gray(clip)[..., None].repeat(3, axis=-1)
    return _blend(g, clip, f)


def contrast(clip: np.ndarray, f: float) -> np.ndarray:
    """Per-value map -> per-frame LUT: mean*(1-f) + i*f."""
    idx = np.arange(256, dtype=np.float64)
    if NA.available():
        # PIL: mean of the grayscale image, rounded via int(mean + 0.5)
        means = np.floor(NA.gray_mean_per_frame(clip) + 0.5)
        luts = np.clip(np.round(means[:, None] * (1.0 - f) + idx[None] * f), 0, 255).astype(np.uint8)
        return NA.lut_per_frame(clip, np.repeat(luts[:, None, :], 3, axis=1))
    import cv2

    out = np.empty_like(clip)
    for t in range(clip.shape[0]):
        # PIL: mean of the grayscale image, rounded via int(mean + 0.5)
        mean = int(_gray(clip[t]).mean() + 0.5)
        lut = np.clip(np.round(mean * (1.0 - f) + idx * f), 0, 255).astype(np.uint8)
        out[t] = cv2.LUT(clip[t], lut)
    return out


def brightness(clip: np.ndarray, f: float) -> np.ndarray:
    lut = np.clip(np.round(np.arange(256, dtype=np.float64) * f), 0, 255)
    return _lut(clip, lut)


_SMOOTH_KERNEL = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0


def sharpness(clip: np.ndarray, f: float) -> np.ndarray:
    if NA.has_sharpness():
        # exact Pillow semantics (truncating blend); the cv2 path below
        # rounds through addWeighted
        return NA.sharpness_blend(clip, f)
    import cv2

    out = np.empty_like(clip)
    for t in range(clip.shape[0]):
        smooth = cv2.filter2D(clip[t], -1, _SMOOTH_KERNEL, borderType=cv2.BORDER_REPLICATE)
        # PIL filters leave the 1-px border untouched
        smooth[0, :] = clip[t, 0, :]
        smooth[-1, :] = clip[t, -1, :]
        smooth[:, 0] = clip[t, :, 0]
        smooth[:, -1] = clip[t, :, -1]
        out[t] = _blend(smooth, clip[t], f)
    return out


def _frame_flags(interpolation, rng, n_frames):
    """Per-frame cv2 interpolation flags. 'random' draws bilinear/bicubic
    independently per frame (ref rand_augment.py:50-55 resolves the random
    choice on every aug_fn call, i.e. per frame)."""
    import cv2

    table = {"bilinear": cv2.INTER_LINEAR, "bicubic": cv2.INTER_CUBIC}
    if interpolation == "random":
        rng = rng or _random
        return [rng.choice((cv2.INTER_LINEAR, cv2.INTER_CUBIC)) for _ in range(n_frames)]
    return [table[interpolation]] * n_frames


def _warp_inverse(clip: np.ndarray, inv: np.ndarray, interpolation="bicubic", rng=None) -> np.ndarray:
    """Apply an inverse-map affine (PIL Image.transform convention)."""
    import cv2

    out = np.empty_like(clip)
    flags = _frame_flags(interpolation, rng, clip.shape[0])
    for t in range(clip.shape[0]):
        out[t] = cv2.warpAffine(
            clip[t], inv, (clip.shape[2], clip.shape[1]),
            flags=flags[t] | cv2.WARP_INVERSE_MAP,
            borderMode=cv2.BORDER_CONSTANT, borderValue=(_FILL, _FILL, _FILL),
        )
    return out


def _native_interp_flags(interpolation, rng, n_frames):
    """Map _frame_flags' cv2 flags to the native core's 1=cubic / 0=linear,
    consuming the SAME rng draws as the cv2 path (a per-frame choice for
    'random'), so the augmentation streams stay the same across the two
    paths."""
    import cv2

    return [int(fl == cv2.INTER_CUBIC) for fl in _frame_flags(interpolation, rng, n_frames)]


def _axis_warp(clip, axis_x: bool, shear: float, off: float, interpolation="bicubic", rng=None):
    """ShearX / TranslateX map src_x = x + shear*y + off (src_y = y);
    ShearY / TranslateY src_y = y + shear*x + off (src_x = x). The native
    core resamples along the one axis (4 taps) with PIL's a=-1.0 cubic and
    its clamp-taps / fill-iff-source-out-of-range edge rule; cv2 warps the
    whole frame."""
    if NA.available():
        flags = _native_interp_flags(interpolation, rng, clip.shape[0])
        return (NA.warp_x if axis_x else NA.warp_y)(clip, shear, off, _FILL, flags)
    if axis_x:
        inv = np.array([[1, shear, off], [0, 1, 0]], np.float32)
    else:
        inv = np.array([[1, 0, 0], [shear, 1, off]], np.float32)
    return _warp_inverse(clip, inv, interpolation=interpolation, rng=rng)


def shear_x(clip: np.ndarray, f: float, **kw) -> np.ndarray:
    return _axis_warp(clip, True, f, 0.0, **kw)


def shear_y(clip: np.ndarray, f: float, **kw) -> np.ndarray:
    return _axis_warp(clip, False, f, 0.0, **kw)


def translate_x_rel(clip: np.ndarray, f: float, **kw) -> np.ndarray:
    return _axis_warp(clip, True, 0.0, float(f * clip.shape[2]), **kw)


def translate_y_rel(clip: np.ndarray, f: float, **kw) -> np.ndarray:
    return _axis_warp(clip, False, 0.0, float(f * clip.shape[1]), **kw)


def rotate(clip: np.ndarray, deg: float, interpolation="bicubic", rng=None) -> np.ndarray:
    import cv2

    h, w = clip.shape[1:3]
    # PIL rotates counterclockwise about the center; cv2's positive angle
    # is also counterclockwise
    m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0)
    out = np.empty_like(clip)
    flags = _frame_flags(interpolation, rng, clip.shape[0])
    for t in range(clip.shape[0]):
        out[t] = cv2.warpAffine(
            clip[t], m, (w, h), flags=flags[t],
            borderMode=cv2.BORDER_CONSTANT, borderValue=(_FILL, _FILL, _FILL),
        )
    return out


FAST_OPS = {
    "AutoContrast": lambda clip, arg: autocontrast(clip),
    "Equalize": lambda clip, arg: equalize(clip),
    "Invert": lambda clip, arg: invert(clip),
    "Posterize": posterize,
    "Solarize": solarize,
    "SolarizeAdd": solarize_add,
    "Color": color,
    "Contrast": contrast,
    "Brightness": brightness,
    "Sharpness": sharpness,
}

GEOMETRIC_FAST_OPS = {
    "Rotate": rotate,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateXRel": translate_x_rel,
    "TranslateYRel": translate_y_rel,
}


def apply_fast_op(clip: np.ndarray, name: str, arg, interpolation: str = "bicubic", rng=None) -> np.ndarray:
    if name in GEOMETRIC_FAST_OPS:
        return GEOMETRIC_FAST_OPS[name](clip, arg, interpolation=interpolation, rng=rng)
    return FAST_OPS[name](clip, arg)

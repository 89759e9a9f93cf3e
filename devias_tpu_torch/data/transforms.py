"""Host-side clip transforms (port of `devias_tpu/data/transforms.py`).

The reference transform stack on numpy [T, H, W, C] uint8 clips, with the
JAX package's rng draws in the same order:

train:      RandAugment (clip-consistent, `fast_augment.py`) ->
            random-resized-crop (scale 0.08-1.0, ratio 3/4-4/3) on uint8 ->
            /255 -> normalize -> horizontal flip (except SSv2) -> optional
            RandomErasing (cube)
validation: short-side resize (bilinear) -> center crop -> /255 -> normalize
test:       short-side resize, then the caller slices the deterministic
            (temporal, spatial) view grid (ref kinetics.py:195-231)

Output: float32 [T, H, W, C], ImageNet-normalized, or uint8 with
`host_normalize=False`. Resizes and flips run in cv2, imported where they
run, so importing this module needs no host imaging library. Only the JAX
package's default (`fast=True`) chain is ported, not its per-frame PIL
variant.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# resize / crop primitives
# ---------------------------------------------------------------------------

def resize_clip_short_side(clip: np.ndarray, short_side: int, interpolation: str = "bilinear") -> np.ndarray:
    """Resize so min(H, W) == short_side, keeping aspect ratio.

    The long side TRUNCATES (int(), not round()) and an already-matching
    short side skips the resize entirely — both exactly as the reference
    (ref utils/functional.py:25-74 get_resize_sizes/resize_clip); a
    one-pixel long-side difference shifts every downstream eval crop."""
    T, H, W = clip.shape[:3]
    if (W <= H and W == short_side) or (H <= W and H == short_side):
        return clip
    if W < H:
        nh, nw = int(short_side * H / W), short_side
    else:
        nh, nw = short_side, int(short_side * W / H)
    return resize_clip(clip, (nh, nw), interpolation)


def resize_clip(clip: np.ndarray, size: Tuple[int, int], interpolation: str = "bilinear") -> np.ndarray:
    import cv2

    nh, nw = size
    if clip.shape[1] == nh and clip.shape[2] == nw:
        return clip
    interp = cv2.INTER_LINEAR if interpolation == "bilinear" else cv2.INTER_CUBIC
    out = np.empty((clip.shape[0], nh, nw, clip.shape[3]), clip.dtype)
    for t in range(clip.shape[0]):
        out[t] = cv2.resize(clip[t], (nw, nh), interpolation=interp)
    return out


def center_crop_clip(clip: np.ndarray, size: int) -> np.ndarray:
    T, H, W = clip.shape[:3]
    # int(round(.)) with banker's rounding, matching the reference exactly
    # (ref video_transforms.py:1165-1166) — differs from //2 by one pixel
    # when the margin is an odd number of half-pixels
    y = int(round((H - size) / 2.0))
    x = int(round((W - size) / 2.0))
    return clip[:, y : y + size, x : x + size]


def random_resized_crop_clip(
    clip: np.ndarray,
    size: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """torchvision RandomResizedCrop semantics on the whole clip (same crop
    for all frames, ref video_transforms.py:540-618): 10 attempts sampling
    area*scale and exp-uniform ratio, else center fallback."""
    rng = rng or random
    T, H, W = clip.shape[:3]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            y = rng.randint(0, H - h)
            x = rng.randint(0, W - w)
            crop = clip[:, y : y + h, x : x + w]
            return resize_clip(crop, (size, size))
    # fallback: center crop to in-ratio box
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    y = (H - h) // 2
    x = (W - w) // 2
    return resize_clip(clip[:, y : y + h, x : x + w], (size, size))


def horizontal_flip_clip(clip: np.ndarray, p: float = 0.5, rng: Optional[random.Random] = None) -> np.ndarray:
    rng = rng or random
    if rng.random() < p:
        if clip.dtype == np.uint8 and clip.ndim == 4 and clip.flags["C_CONTIGUOUS"]:
            import cv2

            # cv2.flip emits a CONTIGUOUS result via SIMD; the numpy
            # negative-stride view makes the downstream ascontiguousarray
            # copy the whole clip one element at a time (~2 ms/clip)
            t, h, w, c = clip.shape
            return cv2.flip(clip.reshape(t * h, w, c), 1).reshape(clip.shape)
        return clip[:, :, ::-1]
    return clip


def normalize_clip(clip: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """uint8 [T,H,W,C] -> float32 normalized (ref kinetics.py:468-485).
    Fused as one multiply-add: x*(1/(255*std)) - mean/std."""
    if clip.dtype == np.uint8:
        scale = (1.0 / (255.0 * np.asarray(std, np.float32))).astype(np.float32)
        bias = (-np.asarray(mean, np.float32) / np.asarray(std, np.float32)).astype(np.float32)
        return clip * scale + bias
    x = clip.astype(np.float32)
    if x.max() > 1.5:  # uint8 range
        x = x / 255.0
    return ((x - mean) / std).astype(np.float32)


# ---------------------------------------------------------------------------
# RandAugment (timm policy 'rand-mN-nK-mstdS-inc1'), clip-consistent
# ---------------------------------------------------------------------------

_MAX_LEVEL = 10.0


def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


# op name -> level->arg mapping; 'inc1' (increasing severity) variants
def _level_to_arg_inc(name, level, rng):
    if name in ("ShearX", "ShearY"):
        return _randomly_negate(level / _MAX_LEVEL * 0.3, rng)
    if name in ("TranslateXRel", "TranslateYRel"):
        return _randomly_negate(level / _MAX_LEVEL * 0.45, rng)
    if name == "Rotate":
        return _randomly_negate(level / _MAX_LEVEL * 30.0, rng)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        return 1.0 + _randomly_negate(level / _MAX_LEVEL * 0.9, rng)
    if name == "Posterize":  # increasing: 4 - (level/10)*4 bits removed
        return 4 - int(level / _MAX_LEVEL * 4)
    if name == "Solarize":
        return 256 - int(level / _MAX_LEVEL * 256)
    if name == "SolarizeAdd":
        return int(level / _MAX_LEVEL * 110)
    return None


_RAND_OPS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


def parse_rand_augment(policy: str):
    """Parse 'rand-m7-n4-mstd0.5-inc1' (ref rand_augment.py:481-531 config
    string grammar; only the rand-* grammar used by DEVIAS is supported)."""
    parts = policy.split("-")
    if parts[0] != "rand":
        raise ValueError(f"unsupported augment policy {policy}")
    magnitude, num_layers, mstd = 10, 2, 0.0
    for p in parts[1:]:
        if p.startswith("mstd"):
            mstd = float(p[4:])
        elif p.startswith("m"):
            magnitude = int(p[1:])
        elif p.startswith("n"):
            num_layers = int(p[1:])
        elif p.startswith("inc"):
            pass  # increasing severity is the only mode implemented
        elif p.startswith("w"):
            pass  # op-weighting not used by the DEVIAS recipes
    return magnitude, num_layers, mstd


def rand_augment_clip(
    clip: np.ndarray, policy: str = "rand-m7-n4-mstd0.5-inc1",
    rng: Optional[random.Random] = None, interpolation: str = "bicubic",
    op_prob: float = 0.5,
) -> np.ndarray:
    """Apply RandAugment with ONE op/param draw per clip, applied to every
    frame (clip-consistent, ref video_transforms.py:620-653). Input/output
    uint8 [T,H,W,C].

    Reference semantics (ref rand_augment.py:337-383):
      * num_layers ops chosen uniformly WITH replacement
      * each chosen op applied with probability `op_prob` (default 0.5)
      * per-op magnitude ~ N(magnitude, mstd), clipped to [0, 10]
      * geometric ops resample with `interpolation`: 'bicubic' (the
        reference --train_interpolation default), 'bilinear', or 'random'
        (per-frame bilinear/bicubic draw, ref rand_augment.py:50-55)
      * grey (128,128,128) fill
    The ops are the whole-clip ones of `fast_augment.py`."""
    from devias_tpu_torch.data.fast_augment import apply_fast_op

    rng = rng or random
    magnitude, num_layers, mstd = parse_rand_augment(policy)
    chosen = []
    for _ in range(num_layers):
        name = rng.choice(_RAND_OPS)
        # per-op apply probability (ref rand_augment.py:342,365)
        if op_prob < 1.0 and rng.random() > op_prob:
            continue
        level = magnitude
        if mstd > 0:
            level = rng.gauss(magnitude, mstd)
        level = min(_MAX_LEVEL, max(0.0, level))
        arg = _level_to_arg_inc(name, level, rng)
        chosen.append((name, arg))

    out = clip
    for name, arg in chosen:
        out = apply_fast_op(out, name, arg, interpolation=interpolation, rng=rng)
    return out


# ---------------------------------------------------------------------------
# RandomErasing — cube mode (same box all frames, ref random_erasing.py:27-80)
# ---------------------------------------------------------------------------

def random_erase_clip(
    clip: np.ndarray,
    prob: float = 0.25,
    min_area: float = 0.02,
    max_area: float = 1 / 3,
    min_aspect: float = 0.3,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Erase one random box (per-pixel gaussian noise fill, 'pixel' mode)
    across all frames of the normalized float clip."""
    rng = rng or random
    if rng.random() > prob:
        return clip
    T, H, W, C = clip.shape
    area = H * W
    log_ratio = (math.log(min_aspect), math.log(1 / min_aspect))
    # 100 placement attempts and per-FRAME fresh gaussian fill, matching the
    # reference cube path exactly (ref random_erasing.py:109-150: the box is
    # shared across frames but _get_pixels draws new noise for each frame)
    for _ in range(100):
        target = rng.uniform(min_area, max_area) * area
        aspect = math.exp(rng.uniform(*log_ratio))
        h = int(round(math.sqrt(target * aspect)))
        w = int(round(math.sqrt(target / aspect)))
        if h < H and w < W:
            y = rng.randint(0, H - h)
            x = rng.randint(0, W - w)
            # noise drawn from the caller's rng stream, so DataConfig.aug_seed
            # makes the whole chain reproducible across processes
            noise = (
                np.random.default_rng(rng.getrandbits(63))
                .normal(size=(T, h, w, C))
                .astype(clip.dtype)
            )
            clip = clip.copy()
            clip[:, y : y + h, x : x + w] = noise
            return clip
    return clip


# ---------------------------------------------------------------------------
# composed pipelines
# ---------------------------------------------------------------------------

def train_augment(
    clip: np.ndarray,
    crop_size: int = 224,
    policy: str = "rand-m7-n4-mstd0.5-inc1",
    horizontal_flip: bool = True,
    reprob: float = 0.0,
    rng: Optional[random.Random] = None,
    host_normalize: bool = True,
    interpolation: str = "bicubic",
) -> np.ndarray:
    """The reference `_aug_frame` chain (ref kinetics.py:239-298) with the
    JAX package's crop-before-normalize order: the RRC runs on uint8 and
    only the crop is normalized."""
    rng = rng or random
    clip = rand_augment_clip(clip, policy, rng, interpolation=interpolation)
    if not host_normalize and reprob == 0:
        # uint8 device-normalize path: ship raw bytes, the model (or step)
        # applies /255 + the ImageNet affine on the card
        clip = random_resized_crop_clip(clip, crop_size, rng=rng)
        if horizontal_flip:
            clip = horizontal_flip_clip(clip, 0.5, rng)
        return np.ascontiguousarray(clip, np.uint8)
    clip = random_resized_crop_clip(clip, crop_size, rng=rng)
    clip = normalize_clip(clip)
    if horizontal_flip:
        clip = horizontal_flip_clip(clip, 0.5, rng)
    if reprob > 0:
        clip = random_erase_clip(clip, reprob, rng=rng)
    return np.ascontiguousarray(clip, np.float32)


def val_transform(clip: np.ndarray, short_side: int = 224, crop_size: int = 224,
                  host_normalize: bool = True) -> np.ndarray:
    clip = resize_clip_short_side(clip, short_side)
    clip = center_crop_clip(clip, crop_size)
    if not host_normalize:
        return np.ascontiguousarray(clip, np.uint8)
    return np.ascontiguousarray(normalize_clip(clip), np.float32)



def test_resize(clip: np.ndarray, short_side: int) -> np.ndarray:
    """The test views' short-side resize, before the caller slices them."""
    return resize_clip_short_side(clip, short_side)

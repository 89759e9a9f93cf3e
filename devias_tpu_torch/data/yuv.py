"""The I420 (YUV 4:2:0) wire (port of `devias_tpu/data/yuv.py`).

The loader may ship uint8 I420 planes [B, T, H*3//2, W], half the bytes
of RGB (`DataConfig.wire_format='yuv420'`): the host packs each
augmented clip with cv2 (`rgb_clip_to_i420`, BT.601 studio range), and
the step unpacks the batch to [0, 1] RGB on the card before FAME
(`i420_to_rgb`: BT.601 limited-range matrix, nearest 2x2 chroma
upsampling, clipped to unit range).
"""

from __future__ import annotations

import numpy as np
import torch

_Y_SCALE = 255.0 / 219.0
_V_R = 1.596027
_U_G = -0.391762
_V_G = -0.812968
_U_B = 2.017232


def rgb_clip_to_i420(clip: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] uint8 RGB -> [T, H*3//2, W] uint8 I420 planes
    (cv2 `COLOR_RGB2YUV_I420`); H and W must be even."""
    import cv2

    T, H, W, _ = clip.shape
    if H % 2 or W % 2:
        raise ValueError(f"I420 needs even H, W; got {(H, W)}")
    out = np.empty((T, H * 3 // 2, W), np.uint8)
    for t in range(T):
        out[t] = cv2.cvtColor(clip[t], cv2.COLOR_RGB2YUV_I420)
    return out


def i420_to_rgb(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., T, H*3//2, W] uint8 I420 -> [..., T, H, W, 3] in [0, 1]."""
    Hp, W = x.shape[-2], x.shape[-1]
    H = Hp * 2 // 3
    lead = x.shape[:-2]
    y = x[..., :H, :].to(dtype)
    u = x[..., H:H + H // 4, :].reshape(*lead, H // 2, W // 2).to(dtype)
    v = x[..., H + H // 4:, :].reshape(*lead, H // 2, W // 2).to(dtype)

    def up2(c):  # nearest 2x in both spatial dims
        return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    # the luma term subtracts with saturation, max(Y - 16, 0), as cv2 does
    yf = (y - 16.0).clamp_min(0.0) * _Y_SCALE
    uf = up2(u) - 128.0
    vf = up2(v) - 128.0
    r = yf + _V_R * vf
    g = yf + _U_G * uf + _V_G * vf
    b = yf + _U_B * uf
    return (torch.stack([r, g, b], dim=-1) * (1.0 / 255.0)).clamp(0.0, 1.0)

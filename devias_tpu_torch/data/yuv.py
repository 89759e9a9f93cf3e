"""I420 (YUV 4:2:0) clips to RGB on the device (port of
`devias_tpu/data/yuv.py::i420_to_rgb`).

The training wire may ship uint8 I420 planes [B, T, H*3//2, W], half the
bytes of RGB; the step unpacks them to [0, 1] RGB before FAME: BT.601
limited-range matrix, nearest 2x2 chroma upsampling, clipped to unit range.
"""

from __future__ import annotations

import torch

_Y_SCALE = 255.0 / 219.0
_V_R = 1.596027
_U_G = -0.391762
_V_G = -0.812968
_U_B = 2.017232


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

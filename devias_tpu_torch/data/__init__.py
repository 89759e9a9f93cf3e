"""Data-side helpers of the port that run on the device."""

from devias_tpu_torch.data.yuv import i420_to_rgb

__all__ = ["i420_to_rgb"]

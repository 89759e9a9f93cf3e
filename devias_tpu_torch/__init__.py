"""DEVIAS in PyTorch and CUDA, for NVIDIA Hopper.

The port of `devias_tpu` (JAX on a TPU). It keeps that package's module
layout and public layouts (clips [B, T, H, W, C], tokens [B, N, D]) and
imports nothing of it. Entry points run on `cuda` unless the caller asks
for `device="cpu"`.
"""

from devias_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or `cuda` when None. Raises when CUDA is asked for and
    absent: the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def require_on(model: nn.Module, dev: torch.device, what: str = "model") -> None:
    """Raise unless `model`'s parameters lie on `dev`'s device type."""
    where = next((p.device for p in model.parameters()), None)
    if where is not None and where.type != dev.type:
        raise ValueError(f"{what} is on {where}, the caller asked for {dev}")


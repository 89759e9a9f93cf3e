"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple, Union

import torch
from torch import nn

DeviceLike = Union[str, torch.device, None]

_CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


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


def device_constant(key: Hashable, device: torch.device, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The constant `make()` (a host tensor) on `device`, made and copied
    once per `key` and device. A step then copies nothing from the host:
    such a copy waits for the card, and a CUDA graph cannot hold it."""
    entry = (key, torch.device(device))
    if entry not in _CONSTANTS:
        _CONSTANTS[entry] = make().to(device)
    return _CONSTANTS[entry]

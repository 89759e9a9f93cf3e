"""Eval step of the port (`devias_tpu/train/step.py::make_eval_step`).

Training steps come with the training slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from devias_tpu_torch.device import DeviceLike, resolve_device


def to_device(videos: Union[np.ndarray, torch.Tensor], device: torch.device) -> torch.Tensor:
    """Clips as a tensor on `device`. A host array bound for the card goes
    through pinned memory, so the copy is asynchronous to the host."""
    x = torch.from_numpy(np.ascontiguousarray(videos)) if isinstance(videos, np.ndarray) else videos
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def make_eval_step(model: nn.Module, output_key: Optional[str] = None,
                   device: DeviceLike = None) -> Callable:
    """Deterministic forward `step(videos)` returning the model's output
    dict, or its `output_key` entry, under `torch.inference_mode()`.
    `videos` may be a numpy array or a tensor; they go to `device` (`cuda`
    unless the caller asks for `cpu`), where the model must already be."""
    dev = resolve_device(device)
    where = next((p.device for p in model.parameters()), None)
    if where is not None and where.type != dev.type:
        raise ValueError(f"model is on {where}, eval step asked for {dev}")
    model.eval()

    def step(videos):
        with torch.inference_mode():
            out = model(to_device(videos, dev))
        return out[output_key] if output_key else out

    return step

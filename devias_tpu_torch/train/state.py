"""Train state of the port (`devias_tpu/train/state.py`): the model with
its float32 master parameters, the optimizer, the step count and an
optional EMA of the parameters. bf16 compute needs no loss scaler. A
state placed over a process layout (`core/dist.py::shard_train_state`)
carries its `Placement`, which says which of these tensors each rank holds
only a slice of.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from devias_tpu_torch.device import DeviceLike, require_on, resolve_device


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.9999
    placement: Optional[Any] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer, use_ema: bool = False,
               ema_decay: float = 0.9999, device: DeviceLike = None) -> "TrainState":
        """A state at step 0 for `model` on `device` (`cuda` unless the
        caller asks for `cpu`)."""
        require_on(model, resolve_device(device))
        ema = {n: p.detach().clone() for n, p in model.named_parameters()} if use_ema else None
        return cls(model=model, optimizer=optimizer, ema_params=ema, ema_decay=ema_decay)

    @torch.no_grad()
    def update_ema(self) -> None:
        """e = d e + (1 - d) p after an update."""
        if self.ema_params is None:
            return
        d = self.ema_decay
        for n, p in self.model.named_parameters():
            e = self.ema_params[n]
            e.mul_(d).add_(p.detach(), alpha=1.0 - d)

"""Classification and mask heads (port of `devias_tpu/nn/heads.py`)."""

from __future__ import annotations

import torch
from torch import nn

from devias_tpu_torch.nn.vit import Linear


class MLPHead(nn.Module):
    """fc1 -> ReLU -> fc2; `out_init_std` is fc2's initial std."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, out_init_std: float = 0.02):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim, init_std=out_init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class MaskPredictor(nn.Module):
    """Slot -> spatial foreground-mask decoder: D -> 512 -> 256 -> out_dim
    MLP with a final float32 sigmoid (key layout `decoder.{0,2,4}`)."""

    def __init__(self, in_dim: int = 768, out_dim: int = 196):
        super().__init__()
        self.decoder = nn.Sequential(
            Linear(in_dim, 512), nn.ReLU(), Linear(512, 256), nn.ReLU(), Linear(256, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.decoder(x).float())

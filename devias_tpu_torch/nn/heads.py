"""Classification and mask heads (port of `devias_tpu/nn/heads.py`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from devias_tpu_torch.nn.agg import TORCH_LN_EPS, LayerNorm
from devias_tpu_torch.nn.vit import Linear, dropout


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


class FusionMLPHead(nn.Module):
    """The downstream slot-fusion MLP head (`devias_tpu/nn/heads.py:59`):
    each token through a down projection (D -> D/2) and a LayerNorm, the
    two concatenated, [an input LayerNorm,] ReLU, dropout in training, and
    the classifier (D -> classes). The reference's quirk is kept: both
    tokens go through `fc_action_down` and `fc_action_ln`; `fc_scene_down`
    and `fc_scene_ln` exist (checkpoints carry them) but feed nothing, so
    they get no gradient."""

    def __init__(self, num_classes: int, in_dim: int = 768, fc_drop_rate: float = 0.0,
                 use_input_ln: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_drop_rate = fc_drop_rate
        self.fc_action_down = Linear(in_dim, in_dim // 2)
        self.fc_scene_down = Linear(in_dim, in_dim // 2)
        self.fc_action_ln = LayerNorm(in_dim // 2, TORCH_LN_EPS, dtype)
        self.fc_scene_ln = LayerNorm(in_dim // 2, TORCH_LN_EPS, dtype)
        self.fc_input_ln = LayerNorm(in_dim, TORCH_LN_EPS, dtype) if use_input_ln else None
        self.classifier = Linear(in_dim, num_classes)

    def forward(self, action_feat: torch.Tensor, scene_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([self.fc_action_ln(self.fc_action_down(f)) for f in (action_feat, scene_feat)], dim=-1)
        if self.fc_input_ln is not None:
            x = self.fc_input_ln(x)
        return self.classifier(dropout(torch.relu(x), self.fc_drop_rate, self.training, generator))

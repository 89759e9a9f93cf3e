"""Slot-to-label matching on the device (port of
`devias_tpu/losses/matching.py`).

DEVIAS matches the slots to exactly two labels (action, scene), so the
optimal assignment is the argmin over ordered slot pairs (i, j), i != j, of
cost_action[i] + cost_scene[j]: exact, and no host round trip.
"""

from __future__ import annotations

from typing import Tuple

import torch


def match_action_scene_slots(cost_action: torch.Tensor,
                             cost_scene: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost_action, cost_scene: [B, S] per-slot costs (lower is better).
    Returns (action_idx [B], scene_idx [B]), the minimisers of
    cost_action[i] + cost_scene[j] with i != j. Among equal totals the pair
    with the smallest flattened i * S + j wins: `torch.argmin` returns the
    first minimum, as `jnp.argmin` does."""
    B, S = cost_action.shape
    if S < 2:
        raise ValueError("need at least 2 slots to assign action and scene")
    pair = cost_action[:, :, None] + cost_scene[:, None, :]
    eye = torch.eye(S, dtype=torch.bool, device=pair.device)
    pair = pair.masked_fill(eye[None], float("inf"))
    flat = pair.reshape(B, S * S).argmin(dim=-1)
    return flat // S, flat % S

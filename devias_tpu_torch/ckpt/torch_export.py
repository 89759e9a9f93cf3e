"""Port models to reference-layout PyTorch checkpoints (the counterpart of
`devias_tpu/ckpt/torch_export.py`, and the inverse of `torch_import.py`).

The port's parameter names are the reference's (model/modeling_slot.py's
module tree), so the export is the model's state dict in float32 on the
host: a tied agg block's one layer appears at every round index, as the
reference's cache_fn tying stores it, because the tied `ModuleList` holds
the same layer at each index. A key outside the reference layout of the
model's kind raises, so what is written always reads back through
`import_torch_state_dict`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from devias_tpu_torch.ckpt.torch_import import KIND_KEYS, MODEL_KINDS


def export_state_dict(model: nn.Module, model_kind: str) -> Dict[str, torch.Tensor]:
    """The reference-layout state dict of a port model of `model_kind`
    (`MODEL_KINDS`): {key: float32 CPU tensor}."""
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"unknown model_kind {model_kind!r}; expected one of {MODEL_KINDS}")
    sd = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in model.state_dict().items()}
    stray = sorted(k for k in sd if not k.startswith(KIND_KEYS[model_kind]))
    if stray:
        raise ValueError(f"{model_kind} model has keys outside the reference layout: {stray}")
    return sd


def save_reference_checkpoint(path: str, model: nn.Module, model_kind: str, epoch: int = 0) -> None:
    """Write a .pth in the reference container layout,
    {'model': state_dict, 'epoch': epoch}."""
    torch.save({"model": export_state_dict(model, model_kind), "epoch": int(epoch)}, path)

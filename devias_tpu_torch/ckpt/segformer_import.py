"""HuggingFace `SegformerForSemanticSegmentation` weights into the port's
Segformer (port of `devias_tpu/ckpt/segformer_import.py`).

The reference loads `nvidia/segformer-b3-finetuned-cityscapes-1024-1024`
from the hub (ref run_slot_finetuning.py:425); the port takes a local
checkpoint: an HF snapshot directory, a `pytorch_model.bin` / `.pth` torch
state dict, a `model.safetensors` file (read with `safetensors` where it
imports; otherwise the load raises and names the file), or an in-memory
dict. The port's module carries HF's key layout, so the import is a
`strict=True` load in float32.
"""

from __future__ import annotations

import os
from typing import Dict, Union

import torch

from devias_tpu_torch.nn.segformer import Segformer


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch or safetensors state dict from a local file or an HF
    snapshot directory."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin", "pytorch_model.pth"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(f"no checkpoint file under {path}")
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as exc:
            raise ImportError(f"{path} is a safetensors file and the safetensors package does not import") from exc
        return load_file(path, device="cpu")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_segformer(model: Segformer, state_dict: Union[str, Dict]) -> Segformer:
    """Load an HF state dict (or a path `load_state_dict` reads) into
    `model` with `strict=True`, every tensor as float32 (the step
    counter of the BatchNorm as it is)."""
    sd = load_state_dict(state_dict) if isinstance(state_dict, str) else state_dict
    own = model.state_dict()
    model.load_state_dict({k: torch.as_tensor(v).to(own[k].dtype) if k in own else v for k, v in sd.items()},
                          strict=True)
    return model

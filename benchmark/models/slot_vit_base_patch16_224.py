"""The DEVIAS slot ViT: the port's `SlotViT` and its plain float32
reference, `reference/model.py::SlotViT`, which share parameter names."""

import torch

from harness import roofline
from harness.entries import program_kwargs
from reference import model as ref_model


def program(m, device):
    from devias_tpu_torch.nn import SlotViT

    with torch.device(device):
        return SlotViT(**program_kwargs(m))


def reference(m):
    return ref_model.SlotViT(m)


def tokens(m):
    """Tubelets x patches: the backbone carries no CLS token."""
    return roofline.patch_tokens(m)


def flops_per_clip(m):
    """The backbone's blocks (`roofline.vit_flops_per_clip`)."""
    return roofline.vit_flops_per_clip(tokens(m), m["embed_dim"], m["depth"], m.get("mlp_ratio", 4.0))

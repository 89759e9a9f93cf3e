"""The plain ViT of the scene teacher: the port's `PlainViT` and its plain
float32 reference, `reference/model.py::PlainViT`, the CLS token through
the head. The reference takes only the CLS form (`use_mean_pooling`
false), the one the published teacher uses."""

import torch

from harness import roofline
from harness.entries import program_kwargs
from reference import model as ref_model


def program(m, device):
    from devias_tpu_torch.nn import PlainViT

    with torch.device(device):
        return PlainViT(**program_kwargs(m))


def reference(m):
    if m.get("use_mean_pooling", True):
        raise ValueError("the reference teacher is the CLS ViT (use_mean_pooling false)")
    return ref_model.PlainViT(m)


def tokens(m):
    """Tubelets x patches, and the CLS token where the model pools none."""
    return roofline.patch_tokens(m) + int(not m.get("use_mean_pooling", True))


def flops_per_clip(m):
    """The blocks (`roofline.vit_flops_per_clip`)."""
    return roofline.vit_flops_per_clip(tokens(m), m["embed_dim"], m["depth"], m.get("mlp_ratio", 4.0))

"""Reference-layout PyTorch checkpoints into the port's modules (port of
`devias_tpu/ckpt/torch_import.py`).

The port's parameter names are the reference's, so the import is nearly
the identity; what stays is the reference's checkpoint surgery (ref
run_slot_finetuning.py:438-499):
  * unwrap the container by `--model_key` ('model|module', then
    'state_dict'), strip `--model_prefix`
  * strip '_orig_mod.' / 'backbone.' / 'encoder.' prefixes
  * drop a head (`head`, and as in the JAX import also `scene_head` and a
    linear `fusion_head`) whose output width is not the expected one
  * bicubic positional-embedding interpolation over the spatial grid only
    (temporal axis preserved; the CLS row before the patches and the
    scene-token rows after them kept)
  * a tied agg block reads its one layer from `agg_block.layers.0` (the
    reference stores the same tensors at every index when
    weight_tie_layers=True, ref agg_block/agg_block.py:90-103)
and the loaded / unused report. What the checkpoint lacks keeps the model's
own initial values (the tolerant load of ref utils/utils.py:330-375); a
shape mismatch elsewhere raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MODEL_KINDS = ("slot", "plain", "multi_task", "slot_fusion")
_BACKBONE = ("patch_embed.", "cls_token", "scene_token", "pos_embed", "blocks.", "norm.")
KIND_KEYS = {"slot": _BACKBONE + ("agg_block.", "mask_predictor.", "head."),
              "plain": _BACKBONE + ("fc_norm.", "head."),
              "multi_task": _BACKBONE + ("head.", "scene_head."),
              "slot_fusion": _BACKBONE + ("agg_block.", "head.", "action_norm.", "scene_norm.", "fusion_head.")}
# heads dropped when their output width is not `expected_head_out`; the JAX
# import applies its check to each of them
# (`devias_tpu/ckpt/torch_import.py:245-280`)
_CHECKED_HEADS = ("head", "scene_head", "fusion_head")


def load_torch_checkpoint_file(path: str, model_key: str = "model|module",
                               model_prefix: str = "") -> Dict[str, torch.Tensor]:
    """Load a .pth into {key: float32 tensor}: the first of `model_key`'s
    '|'-separated entries, or 'state_dict', that holds a dict is the state
    dict (ref run_slot_finetuning.py:447-453; DeepSpeed checkpoints store
    'module'); keys starting with `model_prefix` lose it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in [k for k in model_key.split("|") if k] + ["state_dict"]:
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, torch.Tensor):
            if model_prefix and k.startswith(model_prefix):
                k = k[len(model_prefix):]
            out[k] = v.detach().float()
    return out


def strip_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """ref run_slot_finetuning.py:460-469."""
    out = {}
    for k, v in sd.items():
        for pref in ("_orig_mod.", "backbone.", "encoder."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def interpolate_pos_embed(pos: torch.Tensor, src_spatial: int, dst_spatial: int,
                          num_frames_tokens: int) -> torch.Tensor:
    """Bicubic resize over the HxW grid, keeping the temporal axis
    (ref run_slot_finetuning.py:471-497). pos: [N, D] with
    N = num_frames_tokens * src_spatial^2."""
    D = pos.shape[-1]
    x = pos.reshape(-1, num_frames_tokens, src_spatial, src_spatial, D)
    x = x.reshape(-1, src_spatial, src_spatial, D).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(dst_spatial, dst_spatial), mode="bicubic", align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(num_frames_tokens * dst_spatial * dst_spatial, D)


def _pos_embed(pos: torch.Tensor, n_lead: int, n_trail: int, dst_spatial: int,
               frames_tokens: int) -> torch.Tensor:
    """The pos-embed surgery: the `n_lead` rows before the patches (CLS)
    and the `n_trail` rows after them (scene tokens) kept, the patch rows
    interpolated when their grid is not `dst_spatial`."""
    flat = pos.reshape(-1, pos.shape[-1]) if pos.dim() == 3 else pos
    n = flat.shape[0]
    lead, tokens, trail = flat[:n_lead], flat[n_lead:n - n_trail], flat[n - n_trail:]
    src_spatial = int(round((tokens.shape[0] / frames_tokens) ** 0.5))
    if src_spatial == dst_spatial:
        return pos
    flat = torch.cat([lead, interpolate_pos_embed(tokens, src_spatial, dst_spatial, frames_tokens), trail], dim=0)
    return flat[None] if pos.dim() == 3 else flat


def import_torch_state_dict(sd: Dict[str, torch.Tensor], model_kind: str, agg_depth: int = 0,
                            agg_unique_layers: int = 1, expected_head_out: Optional[int] = None,
                            dst_spatial: Optional[int] = None,
                            frames_tokens: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The tensors a model of `model_kind` (`slot` SlotViT, `plain`
    PlainViT, `multi_task` MultiTaskViT, `slot_fusion` SlotFusionViT)
    takes from a reference state dict, under the port's keys. A tied agg
    block (`agg_unique_layers` 1) gets `agg_block.layers.0`'s tensors at
    each of its `agg_depth` round indices; an untied one reads its first
    `agg_unique_layers` layers. `expected_head_out`: a head
    (`_CHECKED_HEADS`) of another output width is dropped. `dst_spatial` /
    `frames_tokens`: the target patch grid of the pos-embed surgery."""
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"unknown model_kind {model_kind!r}; expected one of {MODEL_KINDS}")
    sd = strip_prefixes(sd)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith(KIND_KEYS[model_kind]):
            continue
        if k == "pos_embed" and dst_spatial is not None and frames_tokens is not None:
            n_trail = sd["scene_token"].shape[-2] if "scene_token" in sd else 0
            v = _pos_embed(v, int("cls_token" in sd), n_trail, dst_spatial, frames_tokens)
        head = k.rsplit(".", 1)[0]
        if head in _CHECKED_HEADS and expected_head_out is not None \
                and sd[f"{head}.weight"].shape[0] != expected_head_out:
            continue  # mismatched head dropped (ref run_slot_finetuning.py:455-458)
        if k.startswith("agg_block.layers."):
            _, _, idx, rest = k.split(".", 3)
            if int(idx) >= agg_unique_layers:
                continue
            if agg_unique_layers == 1:
                for i in range(max(agg_depth, 1)):
                    out[f"agg_block.layers.{i}.{rest}"] = v
                continue
        out[k] = v
    return out


def merge_params(model: nn.Module, imported: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Load `imported` into `model` where it has the key; everything else
    keeps its value. Raises on a shape mismatch. Returns {"loaded": keys,
    "unused_in_ckpt": imported keys the model lacks}."""
    own = model.state_dict()
    loaded, unused = [], []
    for k, v in imported.items():
        if k not in own:
            unused.append(k)
            continue
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(own[k].shape)} vs ckpt {tuple(v.shape)}")
        loaded.append(k)
    with torch.no_grad():
        for k in loaded:
            own[k].copy_(imported[k].to(own[k].dtype))
    return {"loaded": loaded, "unused_in_ckpt": unused}


def load_reference_checkpoint(model: nn.Module, path: str, model_kind: str, model_key: str = "model|module",
                              model_prefix: str = "", **import_kw) -> Tuple[nn.Module, Dict[str, list]]:
    """`load_torch_checkpoint_file` + `import_torch_state_dict` +
    `merge_params` on `model` in place. Returns (model, report)."""
    sd = load_torch_checkpoint_file(path, model_key, model_prefix)
    return model, merge_params(model, import_torch_state_dict(sd, model_kind, **import_kw))

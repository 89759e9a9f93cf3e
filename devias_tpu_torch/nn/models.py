"""The four DEVIAS model families (port of `devias_tpu/nn/models.py`).

| name                              | class         |
|-----------------------------------|---------------|
| slot_vit_base_patch16_224         | SlotViT       |
| vit_base_patch16_224              | PlainViT      |
| disentangle_vit_base_patch16_224  | MultiTaskViT  |
| slot_fusion_vit_base_patch16_224  | SlotFusionViT |

Each extends `VideoViT`, so the backbone's parameters sit at the top of
the module tree (`patch_embed.*`, `blocks.*`, `norm.*`), as in the
reference layout. Outputs are dicts of tensors with the JAX package's
keys. In `train()` mode `fc_drop_rate` dropout applies to what feeds the
head (the slots, the CLS, scene or pooled token), with the backbone's
dropout and drop-path; `forward` takes the `torch.Generator` they draw
from. Every model takes the backbone's `remat` (activation
checkpointing) and geometry (`patch_size`, `mlp_ratio`, `qkv_bias`,
`qk_scale`, `norm_eps`), LayerScale (`init_values`) and the learnable
position embedding (`use_learnable_pos_emb`, a `pos_embed` sized for
`num_frames` x `img_size`^2 clips); the slot and plain ViTs also take
`int8_dense` (w8a8 frozen inference: the int8 student and teacher).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from devias_tpu_torch.device import DeviceLike, resolve_device
from devias_tpu_torch.nn.agg import AggregationBlock, LayerNorm
from devias_tpu_torch.nn.heads import FusionMLPHead, MaskPredictor, MLPHead
from devias_tpu_torch.nn.vit import MLP_RATIO, NORM_EPS, PATCH_SIZE, Linear, VideoViT, dropout, init_weights


def select_slots_by_head(slots: torch.Tensor, slots_head: torch.Tensor, num_classes: int,
                         num_scene_classes: int) -> Dict[str, torch.Tensor]:
    """Pick the action slot (highest max action-class probability) and the
    scene slot (highest max scene-class probability). `torch.argmax`
    returns the first maximum, as `jnp.argmax` does."""
    probs = slots_head.float().softmax(dim=-1)
    action_idx = probs[..., :num_classes].amax(dim=-1).argmax(dim=1)
    scene_idx = probs[..., num_classes:num_classes + num_scene_classes].amax(dim=-1).argmax(dim=1)

    def take(x, idx):
        return x.gather(1, idx.view(-1, 1, 1).expand(-1, 1, x.shape[-1])).squeeze(1)

    return {
        "action_idx": action_idx,
        "scene_idx": scene_idx,
        "action_feat": take(slots, action_idx),
        "scene_feat": take(slots, scene_idx),
        "action_logit": take(slots_head, action_idx),
        "scene_logit": take(slots_head, scene_idx),
    }


def _backbone_kwargs(kw: dict) -> dict:
    keys = ("embed_dim", "depth", "num_heads", "drop_rate", "attn_drop_rate", "drop_path_rate",
            "tubelet_size", "use_learnable_pos_emb", "img_size", "num_frames", "fused_attention", "exact_gelu",
            "patch_embed_mode", "input_norm", "remat", "int8_dense", "mlp_ratio", "qkv_bias", "qk_scale",
            "init_values", "patch_size", "norm_eps", "dtype")
    return {k: kw[k] for k in keys if k in kw}


class SlotViT(VideoViT):
    """DEVIAS student: ViT backbone + slot aggregation + unified
    action/scene head + mask decoder.

    Output dict: slots [B, S, D], slots_head [B, S, A+Sc], mask_predictions
    [B, S, (img/patch)^2] (sigmoid), attn [B, heads, S, N] (last round,
    pre-renorm), and the role-selected action_/scene_ feat, logit and idx
    (argmax selection in 'matching' mode; slot 0 / slot 1 in 'hard_select')."""

    def __init__(self, num_classes: int = 400, num_scene_classes: int = 365, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0, fc_drop_rate: float = 0.0,
                 init_scale: float = 0.001, tubelet_size: int = 2, img_size: int = 224,
                 num_latents: int = 2, agg_depth: int = 4, agg_weights_tie: bool = True,
                 slot_matching_method: str = "matching", head_type: str = "linear",
                 fused_attention: bool = False, exact_gelu: bool = False,
                 patch_embed_mode: Optional[str] = None, input_norm: bool = False, remat: bool = False,
                 mlp_ratio: float = MLP_RATIO, qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 init_values: float = 0.0, patch_size: int = PATCH_SIZE, norm_eps: float = NORM_EPS,
                 use_learnable_pos_emb: bool = False, num_frames: int = 16, int8_dense: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(**_backbone_kwargs(locals()))
        if slot_matching_method not in ("matching", "hard_select"):
            raise ValueError(f"unknown slot_matching_method {slot_matching_method!r}")
        if head_type not in ("linear", "mlp"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.num_classes = num_classes
        self.num_scene_classes = num_scene_classes
        self.img_size = img_size
        self.fc_drop_rate = fc_drop_rate
        self.slot_matching_method = slot_matching_method
        self.agg_block = AggregationBlock(num_latents, embed_dim, agg_depth, agg_weights_tie, dtype=dtype)
        total = num_classes + num_scene_classes
        if head_type == "linear":
            self.head = Linear(embed_dim, total, init_std=0.02 * init_scale)
        else:
            self.head = MLPHead(embed_dim, 512, total, out_init_std=0.02 * init_scale)
        self.mask_predictor = MaskPredictor(embed_dim, (img_size // patch_size) ** 2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                tokens: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """`tokens` [B, N, D], when given, stand in for the backbone's
        (`devias_tpu/nn/models.py:136-146`): the sequence-parallel step
        passes the gathered tokens of `core/dist.py::seq_parallel_tokens`."""
        if x.shape[2] != self.img_size or x.shape[3] != self.img_size:
            raise ValueError(f"clips must be {self.img_size}x{self.img_size}; got {tuple(x.shape)}")
        if tokens is None:
            tokens = self.forward_features(x, generator)
        slots, attn = self.agg_block(tokens, generator)
        slots_head = self.head(dropout(slots, self.fc_drop_rate, self.training, generator))
        out = {
            "slots": slots,
            "slots_head": slots_head,
            "mask_predictions": self.mask_predictor(slots),
            "attn": attn,
        }
        if self.slot_matching_method == "hard_select":
            B = slots.shape[0]
            out.update(
                action_feat=slots[:, 0], scene_feat=slots[:, 1],
                action_logit=slots_head[:, 0], scene_logit=slots_head[:, 1],
                action_idx=torch.zeros(B, dtype=torch.long, device=slots.device),
                scene_idx=torch.ones(B, dtype=torch.long, device=slots.device),
            )
        else:
            out.update(select_slots_by_head(slots, slots_head, self.num_classes, self.num_scene_classes))
        return out


class PlainViT(VideoViT):
    """VideoMAE finetune ViT (the frozen scene teacher): mean-pooled
    `fc_norm` token by default, the CLS token when `use_mean_pooling=False`.
    Returns {"token", "logits"}."""

    def __init__(self, num_classes: int = 400, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, fc_drop_rate: float = 0.0, init_scale: float = 0.001,
                 tubelet_size: int = 2, use_mean_pooling: bool = True,
                 fused_attention: bool = False, exact_gelu: bool = False,
                 patch_embed_mode: Optional[str] = None, input_norm: bool = False, remat: bool = False,
                 int8_dense: bool = False, mlp_ratio: float = MLP_RATIO, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, init_values: float = 0.0, patch_size: int = PATCH_SIZE,
                 norm_eps: float = NORM_EPS, use_learnable_pos_emb: bool = False, img_size: int = 224,
                 num_frames: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__(use_cls_token=not use_mean_pooling, final_norm=not use_mean_pooling,
                         **_backbone_kwargs(locals()))
        self.fc_drop_rate = fc_drop_rate
        self.fc_norm = LayerNorm(embed_dim, 1e-6, dtype) if use_mean_pooling else None
        self.head = Linear(embed_dim, num_classes, init_std=0.02 * init_scale)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens = self.forward_features(x, generator)
        token = tokens[:, 0] if self.fc_norm is None else self.fc_norm(tokens.mean(dim=1))
        return {"token": token,
                "logits": self.head(dropout(token, self.fc_drop_rate, self.training, generator))}


class MultiTaskViT(VideoViT):
    """The multi-task baseline: the ViT with a CLS (action) token before the
    patches and a `scene_token` after them (1570 tokens at 16x224x224), the
    final norm, and separate heads (`head` on the CLS token, `scene_head`
    on the scene token) or, with `unified_head`, one `head` of
    num_classes + num_scene_classes applied to both;
    `use_learnable_pos_emb` learns the positions (`pos_embed` for
    `num_frames` x `img_size`^2 clips). Returns
    {"action_token", "scene_token", "action_logit", "scene_logit"}."""

    def __init__(self, num_classes: int = 400, num_scene_classes: int = 365, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, fc_drop_rate: float = 0.0, init_scale: float = 0.001,
                 tubelet_size: int = 2, unified_head: bool = False, use_learnable_pos_emb: bool = False,
                 img_size: int = 224, num_frames: int = 16, fused_attention: bool = False,
                 exact_gelu: bool = False, patch_embed_mode: Optional[str] = None, input_norm: bool = False,
                 remat: bool = False, mlp_ratio: float = MLP_RATIO, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, init_values: float = 0.0, patch_size: int = PATCH_SIZE,
                 norm_eps: float = NORM_EPS, dtype: torch.dtype = torch.float32):
        super().__init__(use_cls_token=True, num_extra_suffix_tokens=1, **_backbone_kwargs(locals()))
        self.fc_drop_rate = fc_drop_rate
        self.unified_head = unified_head
        std = 0.02 * init_scale
        if unified_head:
            self.head = Linear(embed_dim, num_classes + num_scene_classes, init_std=std)
            self.scene_head = None
        else:
            self.head = Linear(embed_dim, num_classes, init_std=std)
            self.scene_head = Linear(embed_dim, num_scene_classes, init_std=std)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens = self.forward_features(x, generator)
        action_token, scene_token = tokens[:, 0], tokens[:, -1]
        a = dropout(action_token, self.fc_drop_rate, self.training, generator)
        s = dropout(scene_token, self.fc_drop_rate, self.training, generator)
        scene_head = self.head if self.scene_head is None else self.scene_head
        return {"action_token": action_token, "scene_token": scene_token,
                "action_logit": self.head(a), "scene_logit": scene_head(s)}


class SlotFusionViT(VideoViT):
    """The downstream transfer model. `concat`: the pretrained SlotViT's
    backbone and agg block, its unified `head` (num_classes +
    num_scene_classes, used only to select the action and scene slots),
    `action_norm` and `scene_norm` on the two, then a new `fusion_head`
    over both (`FusionMLPHead` for `head_type` 'mlp', one Linear on their
    concatenation for 'linear') with downstream_nb_classes outputs.
    `gap`: no agg block; `action_norm` on the mean token, dropout, and a
    Linear `fusion_head`. Returns {"feat", "logits"} (and "slots" in
    `concat`)."""

    def __init__(self, num_classes: int = 400, num_scene_classes: int = 365, downstream_nb_classes: int = 48,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0, fc_drop_rate: float = 0.0,
                 init_scale: float = 0.001, tubelet_size: int = 2, num_latents: int = 2, agg_depth: int = 8,
                 agg_weights_tie: bool = True, slot_fusion_method: str = "concat", head_type: str = "mlp",
                 use_input_ln: bool = False, fused_attention: bool = False, exact_gelu: bool = False,
                 patch_embed_mode: Optional[str] = None, input_norm: bool = False, remat: bool = False,
                 mlp_ratio: float = MLP_RATIO, qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 init_values: float = 0.0, patch_size: int = PATCH_SIZE, norm_eps: float = NORM_EPS,
                 use_learnable_pos_emb: bool = False, img_size: int = 224, num_frames: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__(**_backbone_kwargs(locals()))
        if slot_fusion_method not in ("concat", "gap"):
            raise ValueError(f"unknown slot_fusion_method {slot_fusion_method!r}")
        if head_type not in ("linear", "mlp"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.num_classes = num_classes
        self.num_scene_classes = num_scene_classes
        self.fc_drop_rate = fc_drop_rate
        self.slot_fusion_method = slot_fusion_method
        std = 0.02 * init_scale
        self.action_norm = LayerNorm(embed_dim, 1e-6, dtype)
        if slot_fusion_method == "gap":
            self.fusion_head = Linear(embed_dim, downstream_nb_classes, init_std=std)
            return
        self.agg_block = AggregationBlock(num_latents, embed_dim, agg_depth, agg_weights_tie, dtype=dtype)
        # the pretrained unified head: slot selection only, the plain 0.02
        # init (`devias_tpu/nn/models.py:468-475`)
        self.head = Linear(embed_dim, num_classes + num_scene_classes)
        self.scene_norm = LayerNorm(embed_dim, 1e-6, dtype)
        if head_type == "mlp":
            self.fusion_head = FusionMLPHead(downstream_nb_classes, embed_dim, fc_drop_rate, use_input_ln, dtype)
        else:
            self.fusion_head = Linear(2 * embed_dim, downstream_nb_classes, init_std=std)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens = self.forward_features(x, generator)
        if self.slot_fusion_method == "gap":
            feat = dropout(self.action_norm(tokens.mean(dim=1)), self.fc_drop_rate, self.training, generator)
            return {"feat": feat, "logits": self.fusion_head(feat)}
        slots, _ = self.agg_block(tokens, generator)
        sel = select_slots_by_head(slots, self.head(slots), self.num_classes, self.num_scene_classes)
        action_feat, scene_feat = self.action_norm(sel["action_feat"]), self.scene_norm(sel["scene_feat"])
        if isinstance(self.fusion_head, FusionMLPHead):
            logits = self.fusion_head(action_feat, scene_feat, generator)
        else:
            logits = self.fusion_head(torch.cat([action_feat, scene_feat], dim=-1))
        return {"feat": torch.cat([action_feat, scene_feat], dim=-1), "logits": logits, "slots": slots}


_REGISTRY = {
    "slot_vit_base_patch16_224": SlotViT,
    "vit_base_patch16_224": PlainViT,
    "disentangle_vit_base_patch16_224": MultiTaskViT,
    "slot_fusion_vit_base_patch16_224": SlotFusionViT,
}


def create_model(name: str, device: DeviceLike = None, seed: int = 0, **kwargs) -> nn.Module:
    """Build a registry model with weights drawn from `seed`, in eval mode
    on `device` (`cuda` unless the caller asks for `cpu`)."""
    dev = resolve_device(device)
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name}; have {sorted(_REGISTRY)}")
    model = _REGISTRY[name](**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

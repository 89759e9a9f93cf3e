"""DEVIAS slot losses and their criteria (port of
`devias_tpu/losses/slot_loss.py`: `devias_slot_loss`, `hvu_slot_loss`,
`multi_task_loss`, the classification criteria and their helpers).

Everything is computed in float32 with the reference's quirks kept, each
noted where it is applied.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from devias_tpu_torch.losses.matching import match_action_scene_slots


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy with integer labels, no reduction."""
    logp = logits.float().log_softmax(dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0]


def soft_target_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Per-sample sum(-target * log_softmax(logits)) (timm's
    SoftTargetCrossEntropy, no reduction)."""
    return -(target_probs.float() * logits.float().log_softmax(dim=-1)).sum(dim=-1)


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """Per-sample (1 - smoothing) NLL + smoothing x the mean of -log p over
    the classes (timm's LabelSmoothingCrossEntropy, no reduction)."""
    logp = logits.float().log_softmax(dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    smooth = -logp.mean(dim=-1)
    return (1.0 - smoothing) * nll + smoothing * smooth


def kl_div_log_target(student_logp: torch.Tensor, teacher_logp: torch.Tensor) -> torch.Tensor:
    """exp(t) (t - s) summed over the classes. The caller applies the
    reference's 'batchmean' divisor, which for the per-sample 1-D call of
    the matching loss is the number of classes."""
    t, s = teacher_logp.float(), student_logp.float()
    return (t.exp() * (t - s)).sum(dim=-1)


def bce_with_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, mean over the last axis. The
    reference feeds it the mask predictor's sigmoid output as logits; the
    caller keeps that quirk."""
    x, y = x.float(), y.float()
    return (F.softplus(x) - x * y).mean(dim=-1)


def pad_teacher_logits(teacher_scene_logit: torch.Tensor, num_action_classes: int,
                       batch_min: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prepend an action block filled with (the batch's smallest logit - 1),
    so the scene class lands at argmax + num_action_classes. `batch_min`
    gives the smallest logit of a batch spread over several processes (the
    JAX step takes it over the global batch); by default it is this
    tensor's."""
    t = teacher_scene_logit.float()
    low = t.min() if batch_min is None else batch_min
    pad = (low - 1.0).expand(t.shape[0], num_action_classes)
    return torch.cat([pad, t], dim=1)


def cosine_orthogonality_loss(slots: torch.Tensor) -> torch.Tensor:
    """Mean off-diagonal cosine similarity between the slots."""
    s = slots.float()
    s = s / s.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bsd,btd->bst", s, s)
    S = sim.shape[1]
    off = sim * (1.0 - torch.eye(S, device=sim.device))
    return (off.sum(dim=(1, 2)) / (S * (S - 1))).mean()


@dataclasses.dataclass(frozen=True)
class SlotLossConfig:
    num_action_classes: int
    num_scene_classes: int = 365
    slot_matching_method: str = "matching"  # 'matching' | 'hard_select'
    scene_criterion: str = "KL"  # 'KL' | 'CE'
    scene_loss_weight: float = 4000.0
    mask_prediction_loss_weight: float = 3.0
    mask_distill_loss_weight: float = 1.0


def _head_mean_attn(attn: torch.Tensor) -> torch.Tensor:
    """[B, heads, S, N] -> [B, S, N], mean over heads."""
    return attn.float().mean(dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x [B, S, ...]."""
    return x.gather(1, idx.view(-1, 1, *([1] * (x.dim() - 2))).expand(-1, 1, *x.shape[2:])).squeeze(1)


def devias_slot_loss(student: Dict[str, torch.Tensor], teacher_scene_logit: torch.Tensor,
                     target: torch.Tensor, fg_mask: torch.Tensor, fg_masks_per_frames: torch.Tensor,
                     cfg: SlotLossConfig, teacher_min: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total loss, action logits [B, C], the five loss terms).
    `teacher_min` is `pad_teacher_logits`' `batch_min`.

    'matching': slots are matched to {action, scene}; the action slot takes
    cross-entropy, the mask-distill MSE against `fg_masks_per_frames` and
    the mask-prediction BCE against `fg_mask`; the scene slot the KL to the
    padded teacher (or CE to its argmax); all slots the cosine term.
    'hard_select': slot 0 is the action slot, slot 1 the scene slot."""
    slots_head = student["slots_head"].float()
    slots = student["slots"].float()
    mask_predictions = student["mask_predictions"].float()
    attn = _head_mean_attn(student["attn"])
    B, S, C = slots_head.shape
    target = target.long()
    fg_mask = fg_mask.float()
    fg_masks_per_frames = fg_masks_per_frames.float()

    teacher_padded = pad_teacher_logits(teacher_scene_logit, cfg.num_action_classes, teacher_min)
    scene_target = teacher_scene_logit.float().argmax(dim=1) + cfg.num_action_classes

    if cfg.slot_matching_method == "hard_select":
        action_loss = cross_entropy(slots_head[:, 0], target).mean()
        scene_kl = kl_div_log_target(slots_head[:, 1].log_softmax(dim=-1), teacher_padded.log_softmax(dim=-1))
        scene_loss = scene_kl.sum() / B * 4.0  # 2-D batchmean => / B, then x4
        mask_distill_loss = ((attn[:, 0] - fg_masks_per_frames) ** 2).mean() * cfg.mask_distill_loss_weight
        mask_prediction_loss = (bce_with_logits(mask_predictions[:, 0], fg_mask).mean()
                                * cfg.mask_prediction_loss_weight)
        cosine_loss = cosine_orthogonality_loss(slots)
        total = action_loss + scene_loss + mask_distill_loss + mask_prediction_loss + cosine_loss
        return total, slots_head[:, 0], {
            "action_loss": action_loss,
            "scene_loss": scene_loss,
            "mask_distill_loss": mask_distill_loss,
            "mask_prediction_loss": mask_prediction_loss,
            "cosine_loss": cosine_loss,
        }
    if cfg.slot_matching_method != "matching":
        raise ValueError(f"unknown slot_matching_method {cfg.slot_matching_method!r}")

    probs = slots_head.softmax(dim=-1)
    cost_action = -probs.gather(-1, target.view(B, 1, 1).expand(B, S, 1))[..., 0]
    cost_scene = -probs.gather(-1, scene_target.view(B, 1, 1).expand(B, S, 1))[..., 0]
    a_idx, s_idx = match_action_scene_slots(cost_action, cost_scene)

    action_slot_logits = _take(slots_head, a_idx)
    scene_slot_logits = _take(slots_head, s_idx)
    action_attn = _take(attn, a_idx)
    action_mask_pred = _take(mask_predictions, a_idx)

    action_loss = cross_entropy(action_slot_logits, target).sum() / B
    mask_distill_loss = (((action_attn - fg_masks_per_frames) ** 2).mean(dim=-1).sum() / B
                         * cfg.mask_distill_loss_weight)
    mask_prediction_loss = (bce_with_logits(action_mask_pred, fg_mask).sum() / B
                            * cfg.mask_prediction_loss_weight)
    if cfg.scene_criterion == "CE":
        scene_loss = cross_entropy(scene_slot_logits, scene_target).sum() / B
    elif cfg.scene_criterion == "KL":
        # per-sample 1-D batchmean divides by the number of classes (quirk)
        scene_kl = kl_div_log_target(scene_slot_logits.log_softmax(dim=-1), teacher_padded.log_softmax(dim=-1)) / C
        scene_loss = scene_kl.sum() / B * cfg.scene_loss_weight
    else:
        raise ValueError(f"unknown scene_criterion {cfg.scene_criterion!r}")

    cosine_loss = cosine_orthogonality_loss(slots)
    total = action_loss + scene_loss + cosine_loss + mask_prediction_loss + mask_distill_loss
    return total, action_slot_logits, {
        "action_loss": action_loss,
        "scene_loss": scene_loss,
        "cosine_loss": cosine_loss,
        "mask_prediction_loss": mask_prediction_loss,
        "mask_distill_loss": mask_distill_loss,
    }


def hvu_slot_loss(student: Dict[str, torch.Tensor], action_targets: torch.Tensor, scene_targets: torch.Tensor,
                  fg_mask: torch.Tensor, fg_masks_per_frames: torch.Tensor, cfg: SlotLossConfig,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The HVU slot loss: real scene labels, no teacher. Returns (total
    loss, action logits [B, C], the five loss terms).

    The scene class is `scene_targets + num_action_classes` in the unified
    head; slots are matched to {action, scene} as in `devias_slot_loss`,
    the action slot takes the cross-entropy and the two mask losses, the
    scene slot the cross-entropy to its label, all slots the cosine term.
    The reference's 'KL' criterion (kl_div of the log-softmax against a
    one-hot target, batchmean over a [1, C] input) reduces exactly to that
    cross-entropy, so `scene_criterion` and `scene_loss_weight` play no
    part. The mask terms take `cfg`'s weights (the reference loss's own
    defaults are 1.0; the HVU CLI passes its flags)."""
    slots_head = student["slots_head"].float()
    slots = student["slots"].float()
    mask_predictions = student["mask_predictions"].float()
    attn = _head_mean_attn(student["attn"])
    B, S, _ = slots_head.shape
    action_targets = action_targets.long()
    scene_target = scene_targets.long() + cfg.num_action_classes

    probs = slots_head.softmax(dim=-1)
    cost_action = -probs.gather(-1, action_targets.view(B, 1, 1).expand(B, S, 1))[..., 0]
    cost_scene = -probs.gather(-1, scene_target.view(B, 1, 1).expand(B, S, 1))[..., 0]
    a_idx, s_idx = match_action_scene_slots(cost_action, cost_scene)

    action_slot_logits = _take(slots_head, a_idx)
    scene_slot_logits = _take(slots_head, s_idx)
    action_attn = _take(attn, a_idx)
    action_mask_pred = _take(mask_predictions, a_idx)

    action_loss = cross_entropy(action_slot_logits, action_targets).sum() / B
    scene_loss = cross_entropy(scene_slot_logits, scene_target).sum() / B
    mask_distill_loss = (((action_attn - fg_masks_per_frames.float()) ** 2).mean(dim=-1).sum() / B
                         * cfg.mask_distill_loss_weight)
    mask_prediction_loss = (bce_with_logits(action_mask_pred, fg_mask).sum() / B
                            * cfg.mask_prediction_loss_weight)
    cosine_loss = cosine_orthogonality_loss(slots)
    total = action_loss + scene_loss + cosine_loss + mask_prediction_loss + mask_distill_loss
    return total, action_slot_logits, {
        "action_loss": action_loss,
        "scene_loss": scene_loss,
        "cosine_loss": cosine_loss,
        "mask_prediction_loss": mask_prediction_loss,
        "mask_distill_loss": mask_distill_loss,
    }


def multi_task_loss(student: Dict[str, torch.Tensor], teacher_scene_logit: torch.Tensor, target: torch.Tensor,
                    num_action_classes: int, logit_criterion: str = "KL", logit_criterion_weight: float = 1.0,
                    unified_head: bool = False, action_criterion: Callable = cross_entropy,
                    teacher_min: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The multi-task baseline's loss (`devias_tpu/losses/slot_loss.py:279`):
    `action_criterion` on the action logits, mean over the batch, plus the
    scene logits' distillation from the teacher: 'KL' to its softmax,
    summed and divided by the batch ('batchmean') times
    `logit_criterion_weight`, or 'CE' to its argmax, mean over the batch
    (unweighted, as the reference). With `unified_head` the teacher's
    logits are padded to the unified width first (`pad_teacher_logits`,
    `teacher_min` its `batch_min`). Returns (total, action logits, the two
    terms)."""
    action_logit = student["action_logit"].float()
    scene_logit = student["scene_logit"].float()
    teacher = teacher_scene_logit.float()
    B = action_logit.shape[0]
    if unified_head:
        teacher = pad_teacher_logits(teacher, num_action_classes, teacher_min)
    action_loss = action_criterion(action_logit, target).mean()
    if logit_criterion == "CE":
        logit_loss = cross_entropy(scene_logit, teacher.argmax(dim=1)).mean()
    elif logit_criterion == "KL":
        logit_loss = (kl_div_log_target(scene_logit.log_softmax(dim=-1), teacher.log_softmax(dim=-1)).sum() / B
                      * logit_criterion_weight)
    else:
        raise ValueError(f"unknown logit_criterion {logit_criterion!r}")
    total = action_loss + logit_loss
    return total, action_logit, {"action_loss": action_loss, "logit_loss": logit_loss}
